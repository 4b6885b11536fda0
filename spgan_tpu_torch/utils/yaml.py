"""A reader for the YAML subset the configs use (no PyYAML needed).

The subset: whole-line and trailing ``#`` comments; nested block mappings
by indentation (spaces); double- or single-quoted and bare strings;
decimal ints; floats with a point (``0.002``, ``1.5e-3``); ``true`` /
``false`` / ``True`` / ``False``; ``null`` / ``Null`` / ``NULL`` / ``~`` and
an empty value (None); flow lists of scalars such as ``[768, 256]``.
Within it a document reads as ``yaml.safe_load`` reads it.  Anything
outside it raises ``YamlSubsetError`` with its line number rather than
reading as something else: block sequences, anchors and tags, multi-line
scalars, nested flow collections, ``yes``/``no``/``on``/``off``, and
numbers that YAML 1.1 would read as strings (``1e-3``) or in another base
(``010``, ``0x1f``).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
# bare tokens YAML 1.1 reads as numbers in another form, or as dates
_NUMBER_LIKE = re.compile(
    r"[-+]?[0-9._]+(?:[eE][-+]?[0-9]+)?$"           # 1e-3, 010, 1_000
    r"|[-+]?0[xXoObB][0-9a-fA-F_]+$"                 # 0x1f, 0o17, 0b101
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"  # 1:30
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")              # 2001-12-14
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.-]*$")
_BOOLS = {"true": True, "True": True, "TRUE": True,
          "false": False, "False": False, "FALSE": False}
_NULLS = {"null", "Null", "NULL", "~", ""}
# YAML 1.1 booleans and special floats this reader does not take
_REFUSED = {"yes", "Yes", "YES", "no", "No", "NO", "on", "On", "ON", "off",
            "Off", "OFF", "y", "Y", "n", "N", ".inf", ".Inf", ".INF",
            "-.inf", "+.inf", ".nan", ".NaN", ".NAN"}
_INDICATORS = set("[]{}&*!|>%@`,?")
_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/"}


class YamlSubsetError(ValueError):
    def __init__(self, lineno: int, msg: str):
        super().__init__(f"line {lineno}: {msg}")
        self.lineno = lineno


def _quoted(text: str, lineno: int) -> Tuple[str, str]:
    """A quoted string at the start of `text` -> (value, rest)."""
    q = text[0]
    out = []
    i = 1
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and ch == '"':
            return "".join(out), text[i + 1:]
        if q == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            if esc not in _ESCAPES:
                raise YamlSubsetError(lineno, f"escape \\{esc} is outside "
                                              "the subset")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        out.append(ch)
        i += 1
    raise YamlSubsetError(lineno, "unterminated quoted string")


def _strip_comment(text: str, lineno: int) -> str:
    """`text` without a trailing comment (a '#' at the start or after
    whitespace), outside quotes only at its start."""
    for i, ch in enumerate(text):
        if ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _plain(tok: str, lineno: int) -> Any:
    """A bare (unquoted) scalar."""
    if tok in _NULLS:
        return None
    if tok in _BOOLS:
        return _BOOLS[tok]
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    if tok in _REFUSED or _NUMBER_LIKE.match(tok):
        raise YamlSubsetError(lineno, f"scalar {tok!r} is outside the subset "
                                      "(quote it if it is a string)")
    if tok[0] in _INDICATORS or tok.startswith(("- ", "---", "...")) \
            or tok == "-" or ": " in tok or tok.endswith(":") or "\t" in tok:
        raise YamlSubsetError(lineno, f"{tok!r} is outside the subset")
    return tok


def _flow_list(text: str, lineno: int) -> List[Any]:
    """`[a, b, ...]` (the whole value) -> list of scalars."""
    body = text[1:]
    items: List[Any] = []
    while True:
        body = body.lstrip()
        if body.startswith("]") and not items:
            rest = body[1:]
            break
        if body[:1] in ("'", '"'):
            val, body = _quoted(body, lineno)
        else:
            m = re.match(r"[^,\[\]{}]*", body)
            tok = m.group(0).strip()
            if not tok:
                raise YamlSubsetError(lineno, "empty or nested item in a "
                                              "flow list")
            val, body = _plain(tok, lineno), body[m.end():]
        items.append(val)
        body = body.lstrip()
        if body.startswith(","):
            body = body[1:]
            continue
        if body.startswith("]"):
            rest = body[1:]
            break
        raise YamlSubsetError(lineno, "flow list not closed on its line")
    if _strip_comment(rest, lineno):
        raise YamlSubsetError(lineno, f"text after a flow list: {rest!r}")
    return items


def _value(text: str, lineno: int) -> Any:
    """The inline value after 'key:' (comment included)."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        val, rest = _quoted(text, lineno)
        if _strip_comment(rest, lineno):
            raise YamlSubsetError(lineno, f"text after a quoted string: "
                                          f"{rest!r}")
        return val
    text = _strip_comment(text, lineno)
    if text.startswith("["):
        return _flow_list(text, lineno)
    return _plain(text, lineno)


def loads(text: str) -> Optional[Dict[str, Any]]:
    """Parse a document of the subset: a (nested) mapping, or None for a
    document with no content (as yaml.safe_load)."""
    lines: List[Tuple[int, int, str]] = []     # (lineno, indent, content)
    for lineno, raw in enumerate(text.splitlines(), 1):
        if lineno == 1 and raw.startswith("\ufeff"):
            raw = raw[1:]
        body = raw.lstrip(" ")
        if not body.strip() or body.lstrip().startswith("#"):
            continue
        if body[0] == "\t":
            raise YamlSubsetError(lineno, "tab indentation is outside the "
                                          "subset")
        lines.append((lineno, len(raw) - len(body), body.rstrip()))
    if not lines:
        return None

    pos = 0

    def block(indent: int) -> Dict[str, Any]:
        nonlocal pos
        out: Dict[str, Any] = {}
        while pos < len(lines):
            lineno, ind, body = lines[pos]
            if ind < indent:
                break
            if ind > indent:
                raise YamlSubsetError(lineno, "unexpected indentation")
            if body[:1] in ("'", '"'):
                key, rest = _quoted(body, lineno)
            else:
                m = re.match(r"([^:#]*?)\s*(?=:(?:\s|$))", body)
                if m is None:
                    raise YamlSubsetError(lineno, f"expected 'key: value', "
                                                  f"got {body!r}")
                key, rest = m.group(1), body[m.end():]
                if not _KEY.match(key):
                    raise YamlSubsetError(lineno, f"key {key!r} is outside "
                                                  "the subset")
            if not rest.startswith(":") or rest[1:2] not in ("", " ", "\t"):
                raise YamlSubsetError(lineno, f"expected ':' after key "
                                              f"{key!r}")
            if key in out:
                raise YamlSubsetError(lineno, f"duplicate key {key!r}")
            pos += 1
            inline = _strip_comment(rest[1:], lineno).strip()
            if inline:
                out[key] = _value(rest[1:], lineno)
            elif pos < len(lines) and lines[pos][1] > indent:
                out[key] = block(lines[pos][1])
            else:
                out[key] = None
        return out

    doc = block(lines[0][1])
    if pos < len(lines):
        raise YamlSubsetError(lines[pos][0], "indentation does not match an "
                                             "enclosing mapping")
    return doc


def load(path: str) -> Optional[Dict[str, Any]]:
    with open(path, encoding="utf-8") as f:
        return loads(f.read())
