"""Attribute-style config access and the reader of the reference's YAML configs
(``foley_tpu/utils/config_utils.py`` counterpart).

``AttributeDict`` is the JAX package's: recursive attribute access over parsed mappings,
with ``get``, ``keys``, ``values``, ``items`` and ``to_dict``. ``load_yaml`` reads the files
without ``yaml`` (the machine with the card has none): ``parse_yaml`` takes the subset of
YAML that the reference's model configs use (``configs/yaml/hunyuanvideo-foley-*.yaml``) and
reads it as ``yaml.safe_load`` does:

- mappings nested by indentation (spaces), one ``key: value`` or ``key:`` a line, bare keys;
- values: ints (``12``, ``-3``), floats with a point (``4.0``, ``1.5e-06``), ``true`` /
  ``false``, ``null`` / ``~``, strings in double or single quotes, and bare strings
  (``bf16``, ``HunyuanVideo-Foley-XXL``);
- comments (``#`` at the start of a line or after a space, outside quotes) and blank lines.

Anything else raises ``ValueError`` naming the file and the line: lists, flow collections
(``[...]``, ``{...}``), anchors, tags, block scalars, several documents, tabs, duplicate keys,
and the bare words whose meaning YAML 1.1 bends (``yes`` / ``no`` / ``on`` / ``off``, ``1e-5``
without a point, ``0x10``, ``.inf``), which ``yaml.safe_load`` reads otherwise than they look.
"""

from __future__ import annotations

import json
import re
from typing import Any, Iterator, List, Optional, Tuple

_IDENT_RE = re.compile(r"[^0-9a-zA-Z_]")
_KEY_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-]*\Z")
_INT_RE = re.compile(r"[-+]?(0|[1-9][0-9]*)\Z")
_FLOAT_RE = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?\Z")
_BARE_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-/]*\Z")
_BOOLS = {"true": True, "True": True, "TRUE": True, "false": False, "False": False,
          "FALSE": False}
_NULLS = {"null", "Null", "NULL", "~"}
_AMBIGUOUS = {"yes", "no", "on", "off", "y", "n"}


def _sanitize_key(key: str) -> str:
    """Make a dict key usable as a Python attribute name."""
    key = _IDENT_RE.sub("_", str(key))
    if key and key[0].isdigit():
        key = "_" + key
    return key


class AttributeDict:
    """Read-mostly recursive attribute wrapper over parsed mappings and lists."""

    def __init__(self, data: Any = None):
        object.__setattr__(self, "_data", {} if data is None else dict(data))

    # -- attribute & item access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        for key, value in data.items():
            if key == name or _sanitize_key(key) == name:
                return _wrap(value)
        raise AttributeError(f"No config key {name!r}; available: {list(data)}")

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = value

    def __getitem__(self, key: str) -> Any:
        return _wrap(self._data[key])

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __repr__(self) -> str:
        return f"AttributeDict({self._data!r})"

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, AttributeDict):
            return self._data == other._data
        return self._data == other

    # -- dict protocol -----------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        if key in self._data:
            return _wrap(self._data[key])
        return default

    def keys(self):
        return self._data.keys()

    def values(self):
        return [_wrap(v) for v in self._data.values()]

    def items(self):
        return [(k, _wrap(v)) for k, v in self._data.items()]

    def to_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, AttributeDict):
                return v.to_dict()
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            return v

        return {k: unwrap(v) for k, v in self._data.items()}


def _wrap(value: Any) -> Any:
    if isinstance(value, dict):
        return AttributeDict(value)
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    return value


def _split_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after whitespace, outside
    quotes."""
    quote: Optional[str] = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str, where: str) -> Any:
    """One value of the subset (the module's docstring lists them)."""
    if text[0] == '"':
        if len(text) < 2 or text[-1] != '"':
            raise ValueError(f"{where}: unterminated double-quoted string {text!r}")
        return json.loads(text)  # JSON's escapes are YAML's for the characters configs use
    if text[0] == "'":
        if len(text) < 2 or text[-1] != "'" or "'" in text[1:-1].replace("''", ""):
            raise ValueError(f"{where}: unterminated single-quoted string {text!r}")
        return text[1:-1].replace("''", "'")
    if text in _BOOLS:
        return _BOOLS[text]
    if text in _NULLS:
        return None
    if _INT_RE.match(text):
        return int(text)
    if _FLOAT_RE.match(text):
        return float(text)
    if text.lower() in _AMBIGUOUS or not _BARE_RE.match(text):
        raise ValueError(f"{where}: {text!r} is outside the YAML subset this reader takes "
                         "(quote a string, give a float a point and a signed exponent)")
    return text


def parse_yaml(text: str, source: str = "<string>") -> dict:
    """The mapping a config file in the subset holds (see the module's docstring)."""
    root: dict = {}
    # open mappings, innermost last: [indentation of their keys (None until the first), dict]
    stack: List[list] = [[0, root]]
    opened: Optional[Tuple[dict, str]] = None  # (parent, key) of a ``key:`` with no value yet
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"{source}:{lineno}"
        line = _split_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        indent = len(line) - len(body)
        if body[0] == "\t" or "\t" in line[:indent]:
            raise ValueError(f"{where}: tabs are not indentation in YAML")
        if body.startswith(("---", "...", "- ")) or body == "-" or body[0] in "[{&*!|>%@`":
            raise ValueError(f"{where}: {body!r} is outside the YAML subset this reader "
                             "takes (nested mappings of scalars)")
        if opened is not None:
            if indent > stack[-2][0]:
                stack[-1][0] = indent  # the first key of the mapping just opened
            else:  # ``key:`` with nothing under it is null, as in YAML
                parent, key = opened
                parent[key] = None
                stack.pop()
            opened = None
        while len(stack) > 1 and indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"{where}: indentation {indent} matches no open mapping")
        key, sep, value = body.partition(":")
        if not sep or (value and value[0] != " "):
            raise ValueError(f"{where}: expected 'key: value', got {body!r}")
        key, value = key.strip(), value.strip()
        if not _KEY_RE.match(key) or key in _BOOLS or key in _NULLS or key.lower() in _AMBIGUOUS:
            raise ValueError(f"{where}: key {key!r} is outside the YAML subset this reader "
                             "takes (bare keys)")
        mapping = stack[-1][1]
        if key in mapping:
            raise ValueError(f"{where}: duplicate key {key!r}")
        if value:
            mapping[key] = _scalar(value, where)
        else:
            mapping[key] = {}
            stack.append([None, mapping[key]])
            opened = (mapping, key)
    if opened is not None:
        parent, key = opened
        parent[key] = None
    return root


def load_yaml(path: str) -> AttributeDict:
    """A config file in the YAML subset as an ``AttributeDict`` (reference
    ``config_utils.py:101-109``)."""
    with open(path, "r", encoding="utf-8") as f:
        return AttributeDict(parse_yaml(f.read(), source=path))


def merge_dicts(base: dict, override: dict) -> dict:
    """Recursive dict merge (reference ``utils/helper.py`` capability)."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = v
    return out
