"""A reader for the YAML subset that the experiment configs use.

The port runs where PyYAML is not installed, so ``utils/config.py`` reads
``experiments_*/**/*.yml`` with this module instead of
``yaml.load(..., FullLoader)``. It returns what ``yaml.safe_load`` returns
for documents made of:

- block mappings and block sequences (``- x``, also compact ``- k: v``),
  a sequence as a mapping's value at the key's own indentation included;
- plain, single-quoted and double-quoted scalars on one line;
- ``#`` comments and blank lines.

Plain scalars resolve as PyYAML's YAML 1.1 resolver does: ``null``/``~``
and the empty value, ``true``/``yes``/``on`` and their negations, ints
(decimal, ``0x``, ``0b``, leading-zero octal, ``_`` separators,
sexagesimal) and floats only with a dot (``5.0e-05`` is a float, ``1e-4``
a string). Anything else — flow collections, anchors and aliases, tags,
block and multi-line scalars, document markers, timestamps, tabs in the
indentation — raises ``ValueError`` naming the line.
"""

from __future__ import annotations

import re

__all__ = ["safe_load"]

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                    (?:[Tt]|[ \t]+)[0-9][0-9]?
                    :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
_BAD_START = "[]{}&*!|>%@`,?"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no, indent, text):
        self.no, self.indent, self.text = no, indent, text


def _error(no, msg):
    return ValueError(f"line {no}: {msg} (outside the YAML subset read "
                      f"here)")


def _sexagesimal(value, cast):
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    total, base = 0, 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return sign * total


def _resolve(text, no):
    """A plain scalar as PyYAML's SafeLoader constructs it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if _TIMESTAMP.match(text):
        raise _error(no, f"timestamp {text!r}")
    return text


def _quoted(text, no):
    """A quoted scalar at the start of ``text`` -> (value, rest)."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        ch = text[i]
        if ch == q:
            if q == "'" and text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if ch == "\\" and q == '"':
            esc = text[i + 1:i + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
                continue
            if esc in _HEX_ESCAPES:
                n = _HEX_ESCAPES[esc]
                digits = text[i + 2:i + 2 + n]
                if not re.fullmatch(f"[0-9a-fA-F]{{{n}}}", digits):
                    raise _error(no, f"bad escape \\{esc}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
                continue
            raise _error(no, f"bad escape \\{esc}")
        out.append(ch)
        i += 1
    raise _error(no, "a quoted scalar that does not end on its line")


def _strip_comment(text):
    """``text`` up to a ``#`` that follows a blank, right-stripped."""
    m = re.search(r"(?:^|[ \t])#", text)
    return (text[:m.start()] if m else text).rstrip()


def _scalar(text, no):
    """A whole value: quoted or plain, with an optional comment after."""
    if text[:1] in "'\"":
        value, rest = _quoted(text, no)
        if _strip_comment(rest):
            raise _error(no, f"text after a quoted scalar: {rest.strip()!r}")
        return value
    text = _strip_comment(text)
    if text[:1] and text[0] in _BAD_START:
        raise _error(no, f"{text[0]!r} (flow collection, anchor, alias, "
                     f"tag or block scalar)")
    if text.startswith("- ") or text == "-":
        raise _error(no, "a sequence entry where a scalar was expected")
    if re.search(r":(?:[ \t]|$)", text):
        raise _error(no, f"a mapping where a scalar was expected: {text!r}")
    return _resolve(text, no)


def _split_key(text, no):
    """'key: rest' -> (key, rest) or None when ``text`` is no mapping
    entry. rest is '' for a key whose value follows on later lines."""
    if text[:1] in "'\"":
        key, rest = _quoted(text, no)
        if not re.match(r":(?:[ \t]|$)", rest):
            return None
        rest = rest[1:].strip()
        return key, "" if rest.startswith("#") else rest
    m = re.search(r":(?:[ \t]|$)", text)
    if m is None:
        return None
    key = text[:m.start()]
    if re.search(r"(?:^|[ \t])#", key):
        return None
    if key[:1] and key[0] in _BAD_START:
        raise _error(no, f"key starting with {key[0]!r}")
    rest = text[m.end():].strip()
    return _resolve(key.rstrip(), no), "" if rest.startswith("#") else rest


def _lines(source):
    out = []
    for no, raw in enumerate(source.splitlines(), 1):
        stripped = raw.lstrip(" ")
        if stripped.startswith("\t") and stripped.strip():
            raise _error(no, "a tab in the indentation")
        text = stripped.rstrip()
        if not text or text.startswith("#"):
            continue
        if text.startswith("%") or text.split(" ")[0] in ("---", "..."):
            raise _error(no, "directives and document markers")
        out.append(_Line(no, len(raw) - len(stripped), text))
    return out


class _Parser:
    def __init__(self, lines):
        self.lines = lines
        self.i = 0

    def peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def node(self, indent):
        """The block node whose first line is the current one, at
        ``indent``."""
        line = self.peek()
        if line.text.startswith("- ") or line.text == "-":
            return self.sequence(indent)
        if _split_key(line.text, line.no) is not None:
            return self.mapping(indent)
        self.i += 1
        value = _scalar(line.text, line.no)
        self.expect_end_of_node(indent, line.no)
        return value

    def expect_end_of_node(self, indent, no):
        nxt = self.peek()
        if nxt is not None and nxt.indent > indent:
            raise _error(nxt.no, f"a multi-line scalar continuing line {no}")

    def value_after(self, line, indent, rest, seq_ok):
        """The value of an entry of the node at ``indent`` whose own text
        ends with ``rest``."""
        if rest:
            value = _scalar(rest, line.no)
            self.expect_end_of_node(indent, line.no)
            return value
        nxt = self.peek()
        if nxt is None or nxt.indent < indent:
            return None
        if nxt.indent > indent:
            return self.node(nxt.indent)
        if seq_ok and (nxt.text.startswith("- ") or nxt.text == "-"):
            # a mapping's sequence value may sit at the key's indentation
            return self.sequence(indent)
        return None

    def mapping(self, indent):
        out = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _error(line.no, "unexpected indentation")
            if line.text.startswith("- ") or line.text == "-":
                raise _error(line.no, "a sequence entry inside a mapping")
            kv = _split_key(line.text, line.no)
            if kv is None:
                raise _error(line.no, f"not a 'key: value' line: "
                             f"{line.text!r}")
            self.i += 1
            key, rest = kv
            out[key] = self.value_after(line, indent, rest, seq_ok=True)

    def sequence(self, indent):
        out = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _error(line.no, "unexpected indentation")
            if not (line.text.startswith("- ") or line.text == "-"):
                return out  # a mapping's sequence value ends here
            body = line.text[1:]
            rest = body.lstrip(" ")
            if rest.startswith("#"):
                rest = ""
            if not rest:
                self.i += 1
                out.append(self.value_after(line, indent, "", seq_ok=False))
                continue
            # compact nesting: '- x' or '- k: v' opens a node at x's column
            self.lines[self.i] = _Line(
                line.no, indent + 1 + len(body) - len(rest), rest)
            out.append(self.node(self.lines[self.i].indent))


def safe_load(source: str):
    """The document in ``source`` as ``yaml.safe_load`` gives it."""
    lines = _lines(source)
    if not lines:
        return None
    parser = _Parser(lines)
    first = lines[0]
    value = parser.node(first.indent)
    extra = parser.peek()
    if extra is not None:
        raise _error(extra.no, "text after the document's top node")
    return value
