"""A reader and writer for the YAML subset of the repo's config files.

The GPU host has no PyYAML, so the port reads `configs/*.yml` and a run's
flat `hparams.yaml` itself. The subset:

- block mappings (nested by indentation), block sequences of scalars,
  comments, and a leading `---`;
- plain, single-quoted and double-quoted scalars, a plain or quoted
  scalar folded over more-indented continuation lines (PyYAML's dumper
  wraps long strings so);
- flow sequences (`[1, 2.0, a]`, nested) and the empty flow mapping `{}`.

Every plain scalar resolves as `yaml.safe_load` resolves it (YAML 1.1):
`True`/`yes`/`on` are booleans, `null`/`~`/empty is None, `5.0E-4` is a
float but `1e-3` (no dot) is a string, `017` is octal, `0x1F` hex, `1:30`
base 60. Anything outside the subset (anchors, tags, block scalars, flow
mappings, dates) raises ValueError rather than being read another way.

`dump` writes a mapping that `yaml.safe_load` reads back equal: keys in
sorted order, strings double-quoted, floats always with a dot.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, List, Tuple

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                                 "OFF")})
_NULL = ("~", "null", "Null", "NULL", "")
# yaml.resolver.Resolver's implicit int and float patterns (YAML 1.1).
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, cast) -> Any:
    sign = -1 if text[0] == "-" else 1
    value, base = cast(0), 1
    for part in reversed(text.lstrip("+-").split(":")):
        value += cast(part) * base
        base *= 60
    return sign * value


def resolve_plain(text: str) -> Any:
    """A plain scalar's value, as yaml.safe_load resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        digits = text.replace("_", "")
        sign = -1 if digits[0] == "-" else 1
        body = digits.lstrip("+-")
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if ":" in body:
            return _sexagesimal(digits, int)
        if body != "0" and body.startswith("0"):
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.match(text):
        digits = text.replace("_", "").lower()
        if digits.endswith(".inf"):
            return -math.inf if digits[0] == "-" else math.inf
        if digits == ".nan":
            return math.nan
        if ":" in digits:
            return _sexagesimal(digits, float)
        return float(digits)
    if _TIMESTAMP.match(text) or text.startswith(("&", "*", "!", "|", ">", "%", "@", "`")):
        raise ValueError(f"YAML construct outside the supported subset: {text!r}")
    return text


def _double_quoted(body: str) -> str:
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        code = body[i + 1]
        if code in _ESCAPES:
            out.append(_ESCAPES[code])
            i += 2
        elif code in _HEX_ESCAPES:
            n = _HEX_ESCAPES[code]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            raise ValueError(f"unknown escape \\{code} in {body!r}")
    return "".join(out)


def _quoted_end(text: str, start: int, open_ok: bool = False) -> int:
    """Index just past the quoted scalar opening at text[start]; with
    `open_ok`, len(text) if it continues on the next line."""
    quote, i = text[start], start + 1
    while i < len(text):
        if quote == "'" and text[i] == "'":
            if text[i + 1:i + 2] == "'":
                i += 2
                continue
            return i + 1
        if quote == '"' and text[i] == "\\":
            i += 2
            continue
        if quote == '"' and text[i] == '"':
            return i + 1
        i += 1
    if open_ok:
        return len(text)
    raise ValueError(f"unterminated quoted scalar: {text[start:]!r}")


def _unquote(text: str) -> str:
    body = text[1:-1]
    return body.replace("''", "'") if text[0] == "'" else _double_quoted(body)


def _strip_comment(line: str) -> str:
    """The line without a trailing comment (a '#' at its start or after
    whitespace, outside quotes)."""
    i = 0
    while i < len(line):
        ch = line[i]
        if ch in "'\"" and (i == 0 or line[i - 1] in " \t[,:-"):
            i = _quoted_end(line, i, open_ok=True)
            continue
        if ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _flow(text: str, i: int) -> Tuple[Any, int]:
    """Parse one flow node starting at text[i] -> (value, index after it)."""
    while text[i] == " ":
        i += 1
    if text[i] == "[":
        items, i = [], i + 1
        while True:
            while text[i] == " ":
                i += 1
            if text[i] == "]":
                return items, i + 1
            value, i = _flow(text, i)
            items.append(value)
            while text[i] == " ":
                i += 1
            if text[i] == ",":
                i += 1
            elif text[i] != "]":
                raise ValueError(f"bad flow sequence: {text!r}")
    if text[i] == "{":
        if text[i + 1:].lstrip().startswith("}"):
            return {}, text.index("}", i) + 1
        raise ValueError(f"flow mappings are outside the supported subset: {text!r}")
    if text[i] in "'\"":
        end = _quoted_end(text, i)
        return _unquote(text[i:end]), end
    end = i
    while end < len(text) and text[end] not in ",]":
        end += 1
    return resolve_plain(text[i:end].strip()), end


def load_value(text: str) -> Any:
    """One scalar or flow node (an inline value), resolved."""
    text = text.strip()
    if text[:1] in ("[", "{", "'", '"'):
        value, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"trailing text after {text[:end]!r}")
        return value
    return resolve_plain(text)


def _split_key(content: str) -> Tuple[str, str] | None:
    """'key: value' -> (key, value text); None if the line is no mapping
    entry."""
    if content[:1] in "'\"":
        end = _quoted_end(content, 0)
        rest = content[end:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] == " "):
            return _unquote(content[:end]), rest[1:].strip()
        return None
    match = re.search(r":(?: |$)", content)
    if match is None or content.startswith("- ") or content == "-":
        return None
    return content[:match.start()].strip(), content[match.end():].strip()


def loads(text: str) -> Any:
    """Parse a document of the subset; an empty one is None."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in indentation are not YAML")
        content = _strip_comment(raw)
        if not content.strip() or content.strip() == "---":
            continue
        lines.append((len(content) - len(content.lstrip()), content.strip()))
    if not lines:
        return None
    value, pos = _block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"unexpected indentation at {lines[pos][1]!r}")
    return value


def _scalar_with_continuations(lines, pos: int, first: str, indent: int) -> Tuple[Any, int]:
    """An inline value plus any more-indented continuation lines, folded
    with single spaces (multi-line plain or quoted scalars)."""
    parts = [first]
    while pos < len(lines) and lines[pos][0] > indent:
        parts.append(lines[pos][1])
        pos += 1
    return load_value(" ".join(parts)), pos


def _block(lines, pos: int, indent: int) -> Tuple[Any, int]:
    """The block node whose entries sit at `indent`, from lines[pos]."""
    if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
        items = []
        while pos < len(lines) and lines[pos][0] == indent and (
                lines[pos][1].startswith("- ") or lines[pos][1] == "-"):
            item = lines[pos][1][1:].strip()
            pos += 1
            if not item and pos < len(lines) and lines[pos][0] > indent:
                raise ValueError("nested block nodes in a sequence are outside the subset")
            value, pos = _scalar_with_continuations(lines, pos, item, indent)
            items.append(value)
        return items, pos
    out: dict = {}
    while pos < len(lines) and lines[pos][0] == indent:
        entry = _split_key(lines[pos][1])
        if entry is None:
            raise ValueError(f"expected 'key: value', got {lines[pos][1]!r}")
        key, rest = entry
        pos += 1
        if key in out:
            raise ValueError(f"duplicate key {key!r}")
        if rest:
            out[key], pos = _scalar_with_continuations(lines, pos, rest, indent)
        elif pos < len(lines) and (lines[pos][0] > indent or (
                lines[pos][0] == indent and lines[pos][1].startswith("- "))):
            out[key], pos = _block(lines, pos, lines[pos][0])
        else:
            out[key] = None
    return out, pos


def load(path) -> Any:
    with open(path) as fh:
        return loads(fh.read())


# -- writing -----------------------------------------------------------------------------

def format_scalar(value: Any) -> str:
    """A value as YAML that yaml.safe_load reads back equal (and typed)."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        mantissa, e, exponent = text.partition("e")
        if "." not in mantissa:
            mantissa += ".0"
        return mantissa + e + exponent
    if isinstance(value, str):
        return json.dumps(value)
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(format_scalar(v) for v in value) + "]"
    raise TypeError(f"cannot write {type(value).__name__} as YAML")


def dump(data: dict, indent: int = 0) -> str:
    """A (nested) mapping as block YAML, keys sorted."""
    lines = []
    for key in sorted(data):
        value = data[key]
        head = " " * indent + format_scalar(str(key)) if _needs_quotes(str(key)) \
            else " " * indent + str(key)
        if isinstance(value, dict) and value:
            lines.append(head + ":")
            lines.append(dump(value, indent + 2).rstrip("\n"))
        elif isinstance(value, dict):
            lines.append(head + ": {}")
        else:
            lines.append(head + ": " + format_scalar(value))
    return "\n".join(lines) + "\n"


def _needs_quotes(key: str) -> bool:
    return not re.match(r"^[A-Za-z_][A-Za-z0-9_.\-]*$", key) or resolve_plain(key) != key
