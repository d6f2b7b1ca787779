"""A reader and a writer for the YAML subset of the job's config files.

The subset is the one ``native/src/yaml_lite.h`` defines: block maps and
block lists, flow ``{}`` and ``[]`` on one line, plain and quoted
scalars, and full-line comments. Plain scalars resolve by YAML 1.1's
rules as ``yaml.safe_load`` applies them (null, bool, int, float, else a
string), so a file in the subset reads back the value PyYAML gives.
Anything outside it (anchors, aliases, tags, block scalars, multi-line
flow collections, a comment after a value, timestamps) raises
:class:`YamlError` rather than being read differently.

:func:`dump` writes block style with sorted keys, as ``yaml.safe_dump``
does, and quotes every string that would read back as something else.
"""

import json
import math
import re
from typing import Any, List, Tuple

__all__ = ["YamlError", "load", "dump"]


class YamlError(ValueError):
    """The document lies outside the supported subset."""


_NULL = re.compile(r"^(?:~|null|Null|NULL)?$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|"
                   r"FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = frozenset(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On",
                   "ON"))
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
# a plain scalar may not start with an indicator
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")


def _resolve_plain(tok: str) -> Any:
    """A plain scalar's value by YAML 1.1's implicit resolvers."""
    if _NULL.match(tok):
        return None
    if _BOOL.match(tok):
        return tok in _TRUE
    if _INT.match(tok):
        s = tok.replace("_", "")
        sign = -1 if s[0] == "-" else 1
        if s[0] in "+-":
            s = s[1:]
        if s == "0":
            return 0
        if s.startswith("0b"):
            return sign * int(s[2:], 2)
        if s.startswith("0x"):
            return sign * int(s[2:], 16)
        if s.startswith("0"):
            return sign * int(s, 8)
        return sign * int(s)
    if _FLOAT.match(tok):
        s = tok.replace("_", "").lower()
        if s.endswith(".inf"):
            return -math.inf if s[0] == "-" else math.inf
        if s.endswith(".nan"):
            return math.nan
        return float(s)
    if _SEXAGESIMAL.match(tok) or _TIMESTAMP.match(tok):
        raise YamlError(f"scalar {tok!r} (sexagesimal or timestamp) is "
                        f"outside the supported subset")
    return tok


def _check_plain(tok: str):
    if tok[0] in "&*!|>%@`":
        raise YamlError(f"{tok!r}: anchors, aliases, tags and block "
                        f"scalars are outside the supported subset")
    if "\t" in tok:
        raise YamlError(f"{tok!r}: a tab in a plain scalar")
    if " #" in tok:
        raise YamlError(f"{tok!r}: a comment after a value is outside the "
                        f"supported subset (full-line comments only)")
    if ": " in tok or tok.endswith(":"):
        raise YamlError(f"{tok!r}: a mapping inside a plain scalar")


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}


def _read_quoted(s: str, i: int) -> Tuple[str, int]:
    """The quoted string starting at ``s[i]``; returns (value, index
    after the closing quote)."""
    q = s[i]
    out: List[str] = []
    i += 1
    while i < len(s):
        c = s[i]
        if q == "'":
            if c == "'":
                if s[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
            i += 1
            continue
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            e = s[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            width = {"x": 2, "u": 4, "U": 8}.get(e)
            if width is None:
                raise YamlError(f"unknown escape \\{e} in {s!r}")
            out.append(chr(int(s[i + 2:i + 2 + width], 16)))
            i += 2 + width
            continue
        out.append(c)
        i += 1
    raise YamlError(f"unterminated quoted scalar in {s!r}")


class _Flow:
    """A one-line flow collection (``{k: v, ...}`` / ``[a, ...]``,
    nesting allowed)."""

    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def parse(self) -> Any:
        v = self._node()
        self._ws()
        if self.i != len(self.s):
            raise YamlError(f"trailing text after a flow collection in "
                            f"{self.s!r}")
        return v

    def _node(self, stops: str = "") -> Any:
        self._ws()
        if self.i >= len(self.s):
            raise YamlError(f"unterminated flow collection {self.s!r}")
        c = self.s[self.i]
        if c in "[{":
            return self._collection()
        if c in "'\"":
            v, self.i = _read_quoted(self.s, self.i)
            return v
        j = self.i
        while j < len(self.s) and self.s[j] not in stops + ",]}":
            if self.s[j] == ":" and (j + 1 == len(self.s)
                                     or self.s[j + 1] in " ,]}"):
                break
            j += 1
        tok = self.s[self.i:j].rstrip()
        self.i = j
        if tok:
            _check_plain(tok)
        return _resolve_plain(tok)

    def _collection(self) -> Any:
        is_map = self.s[self.i] == "{"
        close = "}" if is_map else "]"
        self.i += 1
        out: Any = {} if is_map else []
        while True:
            self._ws()
            if self.i >= len(self.s):
                raise YamlError(f"flow collection not closed on its line: "
                                f"{self.s!r} (multi-line flow is outside "
                                f"the supported subset)")
            if self.s[self.i] == close:
                self.i += 1
                return out
            if is_map:
                key = self._node(":")
                self._ws()
                if self.s[self.i:self.i + 1] != ":":
                    raise YamlError(f"flow map entry without ':' in "
                                    f"{self.s!r}")
                self.i += 1
                self._ws()
                if self.s[self.i:self.i + 1] in (",", close):
                    out[key] = None
                else:
                    out[key] = self._node()
            else:
                out.append(self._node())
            self._ws()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != close:
                raise YamlError(f"expected ',' or {close!r} in {self.s!r}")


def _scalar(tok: str) -> Any:
    """A value written after ``key:`` or ``-`` on its line."""
    if tok[0] in "[{":
        return _Flow(tok).parse()
    if tok[0] in "'\"":
        v, end = _read_quoted(tok, 0)
        if tok[end:].strip():
            raise YamlError(f"text after a quoted scalar: {tok!r}")
        return v
    _check_plain(tok)
    return _resolve_plain(tok)


def _split_key(text: str):
    """``key: rest`` -> (key, rest) or None when ``text`` is no map
    entry."""
    if text[0] in "'\"":
        key, end = _read_quoted(text, 0)
        rest = text[end:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    if text[0] in "[{":
        return None
    for j, c in enumerate(text):
        if c == ":" and (j + 1 == len(text) or text[j + 1] == " "):
            key = text[:j].rstrip()
            _check_plain(key)
            return _resolve_plain(key), text[j + 1:].strip()
    return None


def _lines(doc: str) -> List[Tuple[int, str]]:
    out = []
    for raw in doc.splitlines():
        stripped = raw.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if stripped == "---" and not out:
            continue
        if stripped.startswith(("---", "...", "%")):
            raise YamlError(f"{stripped!r}: directives and multiple "
                            f"documents are outside the supported subset")
        indent = len(raw) - len(raw.lstrip(" "))
        if raw[indent:indent + 1] == "\t":
            raise YamlError("tabs are not allowed for indentation")
        out.append((indent, raw[indent:].rstrip()))
    return out


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Block:
    def __init__(self, lines: List[Tuple[int, str]]):
        self.lines = lines
        self.i = 0

    def _peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def node(self, indent: int) -> Any:
        ind, text = self.lines[self.i]
        if _is_item(text):
            return self._seq(ind)
        if _split_key(text) is not None:
            return self._map(ind)
        if ind != indent and indent >= 0:
            raise YamlError(f"bad indentation at {text!r}")
        self.i += 1
        return _scalar(text)

    def _value_after(self, indent: int, allow_indentless: bool) -> Any:
        nxt = self._peek()
        if nxt is not None and (nxt[0] > indent or (
                allow_indentless and nxt[0] == indent
                and _is_item(nxt[1]))):
            return self.node(nxt[0])
        return None

    def _map(self, indent: int) -> dict:
        out = {}
        while True:
            line = self._peek()
            if line is None or line[0] < indent:
                return out
            if line[0] > indent:
                raise YamlError(f"bad indentation at {line[1]!r}")
            if _is_item(line[1]):
                return out
            kv = _split_key(line[1])
            if kv is None:
                raise YamlError(f"expected 'key: value', got {line[1]!r}")
            key, rest = kv
            self.i += 1
            out[key] = (_scalar(rest) if rest
                        else self._value_after(indent, True))

    def _seq(self, indent: int) -> list:
        out = []
        while True:
            line = self._peek()
            if line is None or line[0] < indent or not _is_item(line[1]):
                if line is not None and line[0] > indent:
                    raise YamlError(f"bad indentation at {line[1]!r}")
                return out
            if line[0] > indent:
                raise YamlError(f"bad indentation at {line[1]!r}")
            rest = line[1][1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self._value_after(indent, False))
                continue
            if _is_item(rest) or _split_key(rest) is not None:
                # the item's first line continues after the dash: parse
                # it as a block at the column where it starts
                col = indent + len(line[1]) - len(rest)
                self.lines[self.i] = (col, rest)
                out.append(self.node(col))
                continue
            self.i += 1
            out.append(_scalar(rest))


def load(text: str) -> Any:
    """The value of a YAML document in the subset; None when empty."""
    lines = _lines(text)
    if not lines:
        return None
    block = _Block(lines)
    value = block.node(lines[0][0])
    if block.i != len(lines):
        raise YamlError(f"unexpected line {lines[block.i][1]!r}")
    return value


def _plain_ok(s: str) -> bool:
    if not s or s != s.strip() or s[0] in _INDICATORS:
        return False
    if any(c in s for c in "\n\r\t#") or ": " in s or s.endswith(":"):
        return False
    if not s.isprintable():
        return False
    try:
        return _resolve_plain(s) == s
    except YamlError:
        return False


def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        if "." not in r and "e" in r:
            r = r.replace("e", ".0e", 1)
        return r
    if isinstance(v, str):
        return v if _plain_ok(v) else json.dumps(v)
    raise YamlError(f"cannot write a {type(v).__name__} as YAML")


def _emit(v: Any, indent: int, out: List[str]):
    pad = " " * indent
    if isinstance(v, dict):
        for k in sorted(v):
            val = v[k]
            key = _scalar_text(k)
            if isinstance(val, (dict, list)) and val:
                out.append(f"{pad}{key}:")
                _emit(val, indent + 2, out)
            else:
                out.append(f"{pad}{key}: {_inline(val)}")
        return
    for item in v:
        if isinstance(item, (dict, list)) and item:
            sub: List[str] = []
            _emit(item, indent + 2, sub)
            out.append(f"{pad}- {sub[0][indent + 2:]}")
            out.extend(sub[1:])
        else:
            out.append(f"{pad}- {_inline(item)}")


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, list):
        return "[]"
    return _scalar_text(v)


def dump(value: Any) -> str:
    """``value`` (dicts, lists, tuples, str, int, float, bool, None) as a
    block-style document with sorted keys."""
    value = _plain_data(value)
    if not isinstance(value, (dict, list)) or not value:
        return _inline(value) + "\n"
    out: List[str] = []
    _emit(value, 0, out)
    return "\n".join(out) + "\n"


def _plain_data(v: Any) -> Any:
    if isinstance(v, dict):
        return {k: _plain_data(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain_data(x) for x in v]
    return v
