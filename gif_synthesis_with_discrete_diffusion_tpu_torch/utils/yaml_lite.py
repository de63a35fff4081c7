"""A reader and an emitter for the subset of YAML the config tree uses.

The port does not need the ``yaml`` package: it reads the JAX package's
config files with this module, never with PyYAML. What it
reads is what ``yaml.safe_load`` gives for the same text, YAML 1.1
resolution included: block mappings and sequences, flow sequences and
mappings, plain, single- and double-quoted scalars, comments. Plain scalars
resolve as PyYAML's implicit resolvers do: ``1e-4`` is a string (a YAML 1.1
float needs a dot), ``5.0e-4`` a float, ``010`` the octal 8, ``yes`` / ``on``
booleans, ``~`` null, ``2001-12-14`` a date. Anchors, aliases, tags, block
scalars (``|``, ``>``) and multi-document streams are refused with
:class:`YamlError`.

:func:`dump` writes block YAML that this reader (and PyYAML) reads back to
the same value: the ``config_tree.log`` of a run.
"""
from __future__ import annotations

import datetime
import json
import math
import re
from typing import Any

__all__ = ["YamlError", "safe_load", "dump"]


class YamlError(ValueError):
    pass


# PyYAML's implicit resolvers (resolver.py, YAML 1.1)
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|"
                   r"FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9_]+(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(
    r"""^(?P<year>[0-9][0-9][0-9][0-9])-(?P<month>[0-9][0-9]?)
    -(?P<day>[0-9][0-9]?)
    (?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9])
    :(?P<second>[0-9][0-9])(?:\.(?P<fraction>[0-9]*))?
    (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
    (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)
_DATE_ONLY = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]$")
_BOOL_VALUES = {"yes": True, "true": True, "on": True,
                "no": False, "false": False, "off": False}


def _sexagesimal(text: str, cast) -> Any:
    value = 0
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _int(text: str) -> int:
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


def _float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * math.inf
    if v == ".nan":
        return math.nan
    if ":" in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


def _timestamp(text: str):
    m = _TIMESTAMP.match(text)
    year, month, day = (int(m.group(k)) for k in ("year", "month", "day"))
    if not m.group("hour"):
        return datetime.date(year, month, day)
    hour, minute, second = (int(m.group(k))
                            for k in ("hour", "minute", "second"))
    fraction = 0
    if m.group("fraction"):
        digits = m.group("fraction")[:6]
        fraction = int(digits + "0" * (6 - len(digits)))
    tzinfo = None
    if m.group("tz_sign"):
        delta = datetime.timedelta(hours=int(m.group("tz_hour")),
                                   minutes=int(m.group("tz_minute") or 0))
        if m.group("tz_sign") == "-":
            delta = -delta
        tzinfo = datetime.timezone(delta)
    elif m.group("tz"):
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, hour, minute, second,
                             fraction, tzinfo=tzinfo)


def resolve_plain(text: str) -> Any:
    """A plain scalar's value, by PyYAML's YAML 1.1 implicit resolvers."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return _BOOL_VALUES[text.lower()]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    if _TIMESTAMP.match(text) and (_DATE_ONLY.match(text)
                                   or _TIMESTAMP.match(text).group("hour")):
        return _timestamp(text)
    return text


# ---------------------------------------------------------------------------
# scanning one line: quoted scalars, flow collections, comments
# ---------------------------------------------------------------------------

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _read_double(s: str, i: int) -> tuple[str, int]:
    """``s[i]`` is the opening quote; -> (value, index after the closer)."""
    out = []
    i += 1
    while i < len(s):
        c = s[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            i += 1
            if i >= len(s):
                break
            e = s[i]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 1
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = s[i + 1:i + 1 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9A-Fa-f]+",
                                                        digits):
                    raise YamlError(f"bad escape in {s!r}")
                out.append(chr(int(digits, 16)))
                i += 1 + n
            else:
                raise YamlError(f"unknown escape \\{e} in {s!r}")
            continue
        out.append(c)
        i += 1
    raise YamlError(f"unterminated double-quoted scalar: {s!r}")


def _read_single(s: str, i: int) -> tuple[str, int]:
    out = []
    i += 1
    while i < len(s):
        c = s[i]
        if c == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise YamlError(f"unterminated single-quoted scalar: {s!r}")


def _strip_comment(line: str) -> str:
    """The line without its comment (a ``#`` at the start or after
    whitespace, outside quotes) and trailing whitespace."""
    i, quote = 0, None
    while i < len(line):
        c = line[i]
        if quote == "'":
            if c == "'":
                if line[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif quote == '"':
            if c == "\\":
                i += 2
                continue
            if c == '"':
                quote = None
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-?"):
            quote = c
        i += 1
    return line.rstrip()


_FLOW_INDICATORS = ",[]{}"
_BAD_PLAIN_START = "&*!|>%@`"


class _Flow:
    """A recursive-descent reader of one flow node (the text of a value that
    starts with ``[`` or ``{``, possibly joined from several lines)."""

    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def _ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def node(self) -> Any:
        self._ws()
        if self.i >= len(self.s):
            raise YamlError(f"unexpected end of flow node: {self.s!r}")
        c = self.s[self.i]
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c == '"':
            v, self.i = _read_double(self.s, self.i)
            return v
        if c == "'":
            v, self.i = _read_single(self.s, self.i)
            return v
        return self._plain()

    def _plain(self) -> Any:
        start = self.i
        c = self.s[start]
        if c in _BAD_PLAIN_START or c in "#":
            raise YamlError(f"unsupported plain scalar in {self.s!r}")
        while self.i < len(self.s):
            c = self.s[self.i]
            if c in _FLOW_INDICATORS:
                break
            if c == ":" and (self.i + 1 == len(self.s)
                             or self.s[self.i + 1] in " \t" + _FLOW_INDICATORS):
                break
            if c == "#" and self.s[self.i - 1] in " \t":
                break
            self.i += 1
        return resolve_plain(self.s[start:self.i].strip())

    def _entry(self) -> tuple[Any, bool, Any]:
        """One entry: (key or item, is_pair, value)."""
        key = self.node()
        self._ws()
        if self.i < len(self.s) and self.s[self.i] == ":":
            self.i += 1
            self._ws()
            if self.i < len(self.s) and self.s[self.i] in ",]}":
                return key, True, None
            return key, True, self.node()
        return key, False, None

    def _seq(self) -> list:
        self.i += 1
        out = []
        while True:
            self._ws()
            if self.i >= len(self.s):
                raise YamlError(f"unterminated flow sequence: {self.s!r}")
            if self.s[self.i] == "]":
                self.i += 1
                return out
            key, pair, value = self._entry()
            out.append({key: value} if pair else key)
            self._ws()
            if self.i < len(self.s) and self.s[self.i] == ",":
                self.i += 1
            elif self.i < len(self.s) and self.s[self.i] != "]":
                raise YamlError(f"expected ',' or ']' in {self.s!r}")

    def _map(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self._ws()
            if self.i >= len(self.s):
                raise YamlError(f"unterminated flow mapping: {self.s!r}")
            if self.s[self.i] == "}":
                self.i += 1
                return out
            key, _, value = self._entry()
            out[key] = value
            self._ws()
            if self.i < len(self.s) and self.s[self.i] == ",":
                self.i += 1
            elif self.i < len(self.s) and self.s[self.i] != "}":
                raise YamlError(f"expected ',' or '}}' in {self.s!r}")


def _scalar_or_flow(text: str) -> Any:
    """The value of an inline node: a flow collection, a quoted or a plain
    scalar (the text has no comment left)."""
    text = text.strip()
    if not text:
        return None
    if text[0] in "[{\"'":
        f = _Flow(text)
        value = f.node()
        f._ws()
        if f.i != len(text):
            raise YamlError(f"trailing text after a node: {text!r}")
        return value
    if text[0] in _BAD_PLAIN_START or text.startswith(("- ", "? ")) \
            or text in ("-", "?"):
        raise YamlError(f"unsupported node: {text!r}")
    if re.search(r":(\s|$)", text):
        raise YamlError(f"mapping values are not allowed here: {text!r}")
    return resolve_plain(text)


# ---------------------------------------------------------------------------
# block structure
# ---------------------------------------------------------------------------

def _split_key(text: str) -> tuple[str, str] | None:
    """``key: rest`` -> (the key's text, rest), or None where the line holds
    no block-mapping key (a key is a quoted scalar or a plain one, followed
    by ``:`` and a space or the end of the line)."""
    if not text or text[0] in "[{":
        return None
    if text[0] in "\"'":
        end = (_read_double if text[0] == '"' else _read_single)(text, 0)[1]
        m = re.match(r"[ \t]*:(?:[ \t]+|$)", text[end:])
        return (text[:end], text[end:][m.end():]) if m else None
    if text[0] in _BAD_PLAIN_START or text[0] in "#,]}" or (
            text[0] in "-?:" and (len(text) == 1 or text[1] in " \t")):
        return None
    m = re.search(r":(?:[ \t]+|$)", text)
    if not m:
        return None
    return text[:m.start()], text[m.end():]


def _key_value(text: str) -> Any:
    if text[0] == '"':
        return _read_double(text, 0)[0]
    if text[0] == "'":
        return _read_single(text, 0)[0]
    return resolve_plain(text.strip())


class _Block:
    def __init__(self, text: str):
        self.lines: list[tuple[int, str]] = []
        for raw in text.splitlines():
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise YamlError("tabs are not allowed as indentation")
            line = _strip_comment(raw)
            if not line.strip():
                continue
            if line.startswith(("---", "...", "%")) and (
                    len(line) == 3 or line[3:4] in " \t"):
                raise YamlError("document markers and directives are not "
                                "supported")
            self.lines.append((len(line) - len(line.lstrip(" ")),
                               line.strip()))
        self.pos = 0

    def parse(self) -> Any:
        if not self.lines:
            return None
        value = self.node(self.lines[0][0])
        if self.pos != len(self.lines):
            raise YamlError(f"unexpected content at: "
                            f"{self.lines[self.pos][1]!r}")
        return value

    def node(self, indent: int) -> Any:
        ind, text = self.lines[self.pos]
        if text == "-" or text.startswith("- "):
            return self.sequence(ind)
        if _split_key(text):
            return self.mapping(ind)
        return self.inline(ind)

    def inline(self, indent: int, text: str | None = None) -> Any:
        """A scalar or flow node, continued on the lines indented past
        ``indent`` (joined by spaces)."""
        if text is None:
            text = self.lines[self.pos][1]
            self.pos += 1
        parts = [text]
        while self.pos < len(self.lines) and self.lines[self.pos][0] > indent:
            parts.append(self.lines[self.pos][1])
            self.pos += 1
        if len(parts) > 1 and parts[0][0] in "\"'":
            raise YamlError("multi-line quoted scalars are not supported")
        return _scalar_or_flow(" ".join(parts))

    def value_after_indicator(self, indent: int, rest: str,
                              seq_ok: bool) -> Any:
        """The value of ``key:`` / ``-`` whose inline remainder is ``rest``;
        nested content sits on lines indented past ``indent`` (a block
        sequence also at ``indent`` itself, when ``seq_ok``)."""
        if rest:
            if rest[0] in "|>":
                raise YamlError("block scalars are not supported")
            if rest[0] in "&*!":
                raise YamlError(f"anchors, aliases and tags are not "
                                f"supported: {rest!r}")
            return self.inline(indent, rest)
        if self.pos >= len(self.lines):
            return None
        ind, text = self.lines[self.pos]
        if ind > indent:
            return self.node(ind)
        if seq_ok and ind == indent and (text == "-" or text.startswith("- ")):
            return self.sequence(ind)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.pos < len(self.lines):
            ind, text = self.lines[self.pos]
            if ind < indent:
                break
            if ind > indent:
                raise YamlError(f"bad indentation at {text!r}")
            split = _split_key(text)
            if not split:
                raise YamlError(f"expected a mapping key at {text!r}")
            self.pos += 1
            out[_key_value(split[0])] = self.value_after_indicator(
                indent, split[1].strip(), seq_ok=True)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.pos < len(self.lines):
            ind, text = self.lines[self.pos]
            if ind != indent or not (text == "-" or text.startswith("- ")):
                if ind > indent:
                    raise YamlError(f"bad indentation at {text!r}")
                break
            rest = text[1:].lstrip(" ")
            col = ind + len(text) - len(rest)
            if rest and (rest == "-" or rest.startswith("- ")
                         or _split_key(rest)):
                # a nested node starting on the item's line: re-read the
                # rest as a line of its own at its column
                self.lines[self.pos] = (col, rest)
                out.append(self.node(col))
            else:
                self.pos += 1
                out.append(self.value_after_indicator(indent, rest,
                                                      seq_ok=False))
        return out


def safe_load(text: str) -> Any:
    """What ``yaml.safe_load(text)`` gives, for the subset above."""
    return _Block(text).parse()


# ---------------------------------------------------------------------------
# emitting
# ---------------------------------------------------------------------------

def _float_text(v: float) -> str:
    if math.isnan(v):
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    text = repr(v).lower()
    if "." not in text and "e" in text:    # 1e-05 is no YAML 1.1 float
        text = text.replace("e", ".0e", 1)
    return text


def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _float_text(v)
    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.isoformat()
    if not isinstance(v, str):
        raise YamlError(f"cannot emit a {type(v).__name__}")
    plain = (v == v.strip() and v and v[0] not in "-?:,[]{}#&*!|>'\"%@`"
             and not re.search(r":(\s|$)|\s#|[,\[\]{}]|[\x00-\x1f\x7f\x85\u2028\u2029]",
                               v)
             and resolve_plain(v) == v and v not in ("-", "?"))
    return v if plain else json.dumps(v, ensure_ascii=False)


def _is_scalar(v: Any) -> bool:
    return not isinstance(v, (dict, list, tuple))


def _emit(v: Any, indent: int, out: list[str]) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for k, item in v.items():
            key = _scalar_text(k)
            if _is_scalar(item) or not item or (
                    isinstance(item, (list, tuple))
                    and all(_is_scalar(x) for x in item)):
                out.append(f"{pad}{key}: {_inline(item)}")
            else:
                out.append(f"{pad}{key}:")
                _emit(item, indent + 2, out)
        return
    for item in v:
        if _is_scalar(item) or not item:
            out.append(f"{pad}- {_inline(item)}")
        else:
            out.append(f"{pad}-")
            _emit(item, indent + 2, out)


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_scalar_text(k)}: {_inline(x)}"
                               for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_inline(x) for x in v) + "]"
    return _scalar_text(v)


def dump(value: Any) -> str:
    """Block YAML of a tree of dicts, lists and scalars (flow style for an
    empty collection and for a list of scalars)."""
    if _is_scalar(value) or not value:
        return _inline(value) + "\n"
    out: list[str] = []
    _emit(value, 0, out)
    return "\n".join(out) + "\n"
