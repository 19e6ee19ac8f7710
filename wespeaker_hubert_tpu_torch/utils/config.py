"""Config parsing for the port's entry points.

Counterpart of `wespeaker_hubert_tpu/utils/config.py`: a config is a dict,
a `.json` file or a `.yaml` / `.yml` file (the training config schema
either way); `apply_overrides` sets dotted `a.b.c=value` paths, and keyword
overrides replace top-level keys.

YAML is read by `loads`, a standard-library reader of the subset the
configs under `examples/` use: block maps and block lists, flow maps
`{a: 1, b: x}` and flow lists `[1, 2]` on one line, plain, single- and
double-quoted scalars, and comments.  It is used whether PyYAML is
installed or not, so every host parses a config alike.  Plain scalars
resolve as PyYAML's `safe_load` resolves them (YAML 1.1): `1e-3` is a
string and `1.0e-3` a float, `yes` / `off` are booleans, `010` is octal.
Anchors, aliases, tags, block scalars (`|`, `>`), multi-line flow
collections, multi-line plain scalars, sexagesimal numbers (`1:30`),
timestamps and the rarer double-quoted escapes are outside the subset and
raise.
"""

from __future__ import annotations

import copy
import json
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

__all__ = [
    "loads",
    "load_config",
    "apply_overrides",
    "coerce_value",
    "parse_config_or_kwargs",
]

# PyYAML's implicit resolvers (yaml/resolver.py), matched on a whole plain
# scalar; a scalar that matches none is a string
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
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
# a scalar that PyYAML reads as a timestamp (detected, to be refused)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# first characters that PyYAML's resolvers are keyed on
_NUMERIC_FIRST = set("-+0123456789.")
_DOUBLE_ESCAPES = {"0": "\0", "b": "\x08", "t": "\t", "n": "\n", "f": "\x0c", "r": "\r",
                   '"': '"', "/": "/", "\\": "\\"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class YamlSubsetError(ValueError):
    """YAML outside the subset this reader takes, or malformed."""


def _construct_int(text: str) -> int:
    value = text.replace("_", "")
    sign = 1
    if value[0] == "-":
        sign = -1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    return sign * int(value)


def _construct_float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = 1
    if value[0] == "-":
        sign = -1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    return sign * float(value)


def resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar -> its value under PyYAML's safe_load."""
    first = text[:1]
    if first in "yYnNtTfFoO" and _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if (first in "nN~" or text == "") and _NULL.match(text):
        return None
    if first in _NUMERIC_FIRST:
        is_float = bool(_FLOAT.match(text))
        is_int = not is_float and first != "." and bool(_INT.match(text))
        # of the two resolvers, only the sexagesimal forms hold a ':'
        if ((is_float or is_int) and ":" in text) or (
                not (is_float or is_int) and first.isdigit() and _TIMESTAMP.match(text)):
            raise YamlSubsetError(f"{text!r}: sexagesimal numbers and timestamps are outside "
                                  "the YAML subset")
        if is_float:
            return _construct_float(text)
        if is_int:
            return _construct_int(text)
    if text in ("<<", "=") or first in "!&*|>%@`":
        raise YamlSubsetError(f"{text!r}: merge keys, '=', tags, anchors, aliases, block "
                              "scalars and reserved indicators are outside the YAML subset")
    return text


class _Scanner:
    """One line's inline content: scalars, flow collections, comments."""

    def __init__(self, text: str, where: str):
        self.s, self.i, self.where = text, 0, where

    def fail(self, msg: str):
        raise YamlSubsetError(f"{self.where}: {msg}: {self.s!r}")

    def skip_space(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def at_end(self) -> bool:
        """Only whitespace and a comment remain."""
        self.skip_space()
        return self.i >= len(self.s) or self.s[self.i] == "#"

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out: List[str] = []
        while True:
            if self.i >= len(self.s):
                self.fail("unterminated quoted scalar (multi-line scalars are outside the subset)")
            c = self.s[self.i]
            if q == "'":
                if c == "'":
                    if self.s[self.i + 1:self.i + 2] == "'":
                        out.append("'")
                        self.i += 2
                        continue
                    self.i += 1
                    return "".join(out)
                out.append(c)
                self.i += 1
                continue
            if c == '"':
                self.i += 1
                return "".join(out)
            if c == "\\":
                e = self.s[self.i + 1:self.i + 2]
                if e in _DOUBLE_ESCAPES:
                    out.append(_DOUBLE_ESCAPES[e])
                    self.i += 2
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    code = self.s[self.i + 2:self.i + 2 + n]
                    if len(code) != n or not all(ch in "0123456789abcdefABCDEF" for ch in code):
                        self.fail(f"bad escape \\{e}{code}")
                    out.append(chr(int(code, 16)))
                    self.i += 2 + n
                else:
                    self.fail(f"unknown escape \\{e}")
                continue
            out.append(c)
            self.i += 1

    def plain(self, flow: bool) -> str:
        """A plain scalar: it ends at ' #', at ': ' (a key's end, or ':'
        before a flow indicator in flow context), and in flow context at
        ',', ']' or '}'."""
        start = self.i
        s = self.s
        while self.i < len(s):
            c = s[self.i]
            if c == "#" and self.i > start and s[self.i - 1] in " \t":
                break
            if c == ":":
                nxt = s[self.i + 1:self.i + 2]
                if nxt in ("", " ", "\t") or (flow and nxt in ",[]{}"):
                    break
            if flow and c in ",[]{}":
                break
            self.i += 1
        return s[start:self.i].rstrip()

    def node(self, flow: bool) -> Any:
        """A scalar or flow collection at the cursor."""
        self.skip_space()
        if self.i >= len(self.s):
            return None
        c = self.s[self.i]
        if c == "[":
            return self.flow_seq()
        if c == "{":
            return self.flow_map()
        if c in "'\"":
            return self.quoted()
        return resolve_plain(self.plain(flow))

    def key(self, flow: bool) -> Tuple[Any, bool]:
        """A map key and whether it was followed by ':'."""
        self.skip_space()
        c = self.s[self.i:self.i + 1]
        if c in ("'", '"'):
            k = self.quoted()
        elif c in ("[", "{"):
            self.fail("collection keys are outside the subset")
        else:
            k = resolve_plain(self.plain(flow))
        self.skip_space()
        if self.s[self.i:self.i + 1] == ":":
            self.i += 1
            return k, True
        return k, False

    def flow_seq(self) -> list:
        self.i += 1
        out: list = []
        while True:
            self.skip_space()
            if self.i >= len(self.s):
                self.fail("unterminated flow list (multi-line flow collections are outside "
                          "the subset)")
            if self.s[self.i] == "]":
                self.i += 1
                return out
            save = self.i
            item = self.node(flow=True)
            self.skip_space()
            if self.s[self.i:self.i + 1] == ":" and not isinstance(item, (list, dict)):
                # a single-pair map inside a flow list: [a: 1]
                self.i = save
                k, _ = self.key(flow=True)
                item = {k: self.node(flow=True)}
                self.skip_space()
            out.append(item)
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != "]":
                self.fail("expected ',' or ']' in a flow list")

    def flow_map(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self.skip_space()
            if self.i >= len(self.s):
                self.fail("unterminated flow map (multi-line flow collections are outside "
                          "the subset)")
            if self.s[self.i] == "}":
                self.i += 1
                return out
            k, has_value = self.key(flow=True)
            out[k] = self.node(flow=True) if has_value else None
            self.skip_space()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != "}":
                self.fail("expected ',' or '}' in a flow map")


def _key_split(content: str) -> Optional[int]:
    """Index of the ':' that ends a block-map key on this line, or None."""
    sc = _Scanner(content, "")
    c = content[:1]
    if c in ("'", '"'):
        try:
            sc.quoted()
        except YamlSubsetError:
            return None
    elif c in ("[", "{"):
        return None
    else:
        sc.plain(flow=False)
    sc.skip_space()
    if content[sc.i:sc.i + 1] == ":" and content[sc.i + 1:sc.i + 2] in ("", " ", "\t"):
        return sc.i
    return None


def loads(text: str) -> Any:
    """Parse one YAML document of the subset (see the module docstring)."""
    lines: List[Tuple[int, str, int]] = []  # (indent, content, line number)
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f"line {n}: tab in indentation")
        stripped = raw.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if stripped.startswith("---") and stripped[3:4] in ("", " ", "\t"):
            if lines:
                raise YamlSubsetError(f"line {n}: more than one document")
            rest = stripped[3:].strip()
            if rest and not rest.startswith("#"):
                lines.append((0, rest, n))
            continue
        if stripped == "...":
            break
        if stripped.startswith("%"):
            raise YamlSubsetError(f"line {n}: directives are outside the subset")
        lines.append((len(raw) - len(raw.lstrip(" ")), raw.strip(" "), n))
    if not lines:
        return None
    node, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise YamlSubsetError(f"line {lines[i][2]}: unexpected indentation")
    return node


def _inline(content: str, n: int) -> Any:
    sc = _Scanner(content, f"line {n}")
    value = sc.node(flow=False)
    if not sc.at_end():
        sc.fail("trailing content")
    return value


def _is_seq_item(content: str) -> bool:
    return content == "-" or content.startswith(("- ", "-\t"))


def _block(lines, i: int, indent: int) -> Tuple[Any, int]:
    """The block node whose lines start at `i` with this indent."""
    _, content, n = lines[i]
    if _is_seq_item(content):
        return _block_seq(lines, i, indent)
    if _key_split(content) is not None:
        return _block_map(lines, i, indent)
    value = _inline(content, n)
    if i + 1 < len(lines) and lines[i + 1][0] > indent:
        raise YamlSubsetError(f"line {lines[i + 1][2]}: multi-line plain scalars are outside "
                              "the subset")
    return value, i + 1


def _child(lines, i: int, indent: int, allow_seq_same_indent: bool) -> Tuple[Any, int]:
    """The value on the lines after a 'key:' or '-' with nothing after it."""
    if i < len(lines):
        nxt_indent, nxt, _ = lines[i]
        if nxt_indent > indent:
            return _block(lines, i, nxt_indent)
        if allow_seq_same_indent and nxt_indent == indent and _is_seq_item(nxt):
            return _block_seq(lines, i, indent)
    return None, i


def _block_seq(lines, i: int, indent: int) -> Tuple[list, int]:
    out = []
    while i < len(lines) and lines[i][0] == indent and _is_seq_item(lines[i][1]):
        _, content, n = lines[i]
        rest = content[1:]
        item_text = rest.lstrip(" \t")
        if not item_text or item_text.startswith("#"):
            value, i = _child(lines, i + 1, indent, allow_seq_same_indent=False)
        else:
            # the item's content starts a node at its own column: '- a: 1'
            # begins a map whose later keys align with 'a'
            col = indent + 1 + (len(rest) - len(item_text))
            lines[i] = (col, item_text, n)
            value, i = _block(lines, i, col)
        out.append(value)
    if i < len(lines) and lines[i][0] > indent:
        raise YamlSubsetError(f"line {lines[i][2]}: unexpected indentation")
    return out, i


def _block_map(lines, i: int, indent: int) -> Tuple[dict, int]:
    out: dict = {}
    while i < len(lines) and lines[i][0] == indent:
        _, content, n = lines[i]
        if _is_seq_item(content):
            raise YamlSubsetError(f"line {n}: a list item inside a map")
        colon = _key_split(content)
        if colon is None:
            raise YamlSubsetError(f"line {n}: expected 'key: value': {content!r}")
        sc = _Scanner(content[:colon], f"line {n}")
        key, _ = sc.key(flow=False)
        rest = content[colon + 1:]
        if not rest.strip() or rest.strip().startswith("#"):
            value, i = _child(lines, i + 1, indent, allow_seq_same_indent=True)
        else:
            value = _inline(rest, n)
            i += 1
            if i < len(lines) and lines[i][0] > indent:
                raise YamlSubsetError(f"line {lines[i][2]}: multi-line plain scalars are "
                                      "outside the subset")
        out[key] = value
    if i < len(lines) and lines[i][0] > indent:
        raise YamlSubsetError(f"line {lines[i][2]}: unexpected indentation")
    return out, i


def load_config(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        return loads(text) or {}
    return json.loads(text)


def coerce_value(raw: str) -> Any:
    """A command-line value: parsed as a YAML scalar or flow collection, a
    string that reads as a number becoming that number ('1e-3')."""
    value = loads(raw)
    if isinstance(value, str):
        try:
            value = int(value)
        except ValueError:
            try:
                value = float(value)
            except ValueError:
                pass
    return value


def apply_overrides(config: Dict[str, Any], overrides: Iterable[str]) -> Dict[str, Any]:
    """Apply 'a.b.c=value' overrides (values through coerce_value)."""
    out = copy.deepcopy(config)
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must be key=value")
        key, raw = item.split("=", 1)
        value = coerce_value(raw)
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def parse_config_or_kwargs(
    config: Union[str, Dict[str, Any]], overrides: Optional[Iterable[str]] = None, **kwargs
) -> Dict[str, Any]:
    """A config dict or file, then dotted `overrides`, then keyword
    overrides of top-level keys (they win)."""
    out = copy.deepcopy(config) if isinstance(config, dict) else load_config(config)
    if overrides:
        out = apply_overrides(out, overrides)
    out.update(kwargs)
    return out
