"""Minimal HOCON-style config parser.

The port's own copy of ``vision_transformers_tpu/config/hocon.py`` (stdlib
only), so the port reads no file of the JAX package; the two must parse
every ``.conf`` and override alike (tests/test_torch_port_package.py).

The reference framework (rosinality/vision-transformers-pytorch) drives training
from HOCON-ish ``.conf`` files loaded by ``tensorfn.load_arg_config``
(reference: train.py:392, README.md:52-54).  This module reimplements the
subset of HOCON those files actually use, with zero external dependencies:

- nested ``{ ... }`` objects with ``key: value`` (or ``key = value``) pairs
- ``[ ... ]`` lists
- optional commas between items (newline also separates)
- ``#`` and ``//`` comments
- numbers (int / float / scientific), booleans, null, quoted and bare strings
- an implicit top-level object (no surrounding braces required)
- ``key.path=value`` dotted overrides (for the CLI ``key=value`` syntax,
  reference README.md:53)
"""

from __future__ import annotations

from typing import Any

__all__ = ["loads", "load", "apply_overrides", "parse_value"]


class HoconError(ValueError):
    pass


_WS = " \t\r"
_BARE_END = set("{}[],:\n#")


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.n = len(text)

    # -- low-level helpers ---------------------------------------------------
    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < self.n else ""

    def _skip_ws(self, newlines: bool = True) -> None:
        while self.pos < self.n:
            c = self.text[self.pos]
            if c in _WS or (newlines and c == "\n"):
                self.pos += 1
            elif c == "#" or self.text.startswith("//", self.pos):
                while self.pos < self.n and self.text[self.pos] != "\n":
                    self.pos += 1
            else:
                break

    def _error(self, msg: str) -> HoconError:
        line = self.text.count("\n", 0, self.pos) + 1
        return HoconError(f"{msg} (line {line})")

    # -- grammar -------------------------------------------------------------
    def parse(self) -> dict:
        self._skip_ws()
        if self._peek() == "{":
            obj = self._object()
        else:
            obj = self._object(implicit=True)
        self._skip_ws()
        if self.pos != self.n:
            raise self._error(f"trailing content: {self.text[self.pos:self.pos+20]!r}")
        return obj

    def _object(self, implicit: bool = False) -> dict:
        out: dict = {}
        if not implicit:
            assert self._peek() == "{"
            self.pos += 1
        while True:
            self._skip_ws()
            c = self._peek()
            if c == ",":
                self.pos += 1
                continue
            if c == "}":
                if implicit:
                    raise self._error("unexpected '}'")
                self.pos += 1
                return out
            if c == "":
                if implicit:
                    return out
                raise self._error("unterminated object")
            key = self._key()
            self._skip_ws(newlines=False)
            c = self._peek()
            if c in ":=":
                self.pos += 1
                value = self._value()
            elif c == "{":  # ``key { ... }`` shorthand
                value = self._object()
            else:
                raise self._error(f"expected ':' after key {key!r}")
            # Dotted keys create nested objects; duplicate object keys merge.
            self._assign(out, key.split("."), value)

    def _assign(self, obj: dict, path: list[str], value: Any) -> None:
        for part in path[:-1]:
            nxt = obj.get(part)
            if not isinstance(nxt, dict):
                nxt = {}
                obj[part] = nxt
            obj = nxt
        leaf = path[-1]
        if isinstance(value, dict) and isinstance(obj.get(leaf), dict):
            _deep_merge(obj[leaf], value)
        else:
            obj[leaf] = value

    def _key(self) -> str:
        c = self._peek()
        if c in "\"'":
            return self._quoted()
        start = self.pos
        while self.pos < self.n and self.text[self.pos] not in _BARE_END \
                and self.text[self.pos] not in _WS and self.text[self.pos] != "=":
            self.pos += 1
        if self.pos == start:
            raise self._error("expected a key")
        return self.text[start:self.pos]

    def _value(self) -> Any:
        self._skip_ws(newlines=False)
        c = self._peek()
        if c == "\n" or c == "":
            raise self._error("expected a value")
        if c == "{":
            return self._object()
        if c == "[":
            return self._list()
        if c in "\"'":
            return self._quoted()
        return self._bare()

    def _list(self) -> list:
        assert self._peek() == "["
        self.pos += 1
        out: list = []
        while True:
            self._skip_ws()
            c = self._peek()
            if c == ",":
                self.pos += 1
                continue
            if c == "]":
                self.pos += 1
                return out
            if c == "":
                raise self._error("unterminated list")
            out.append(self._value())

    def _quoted(self) -> str:
        quote = self._peek()
        self.pos += 1
        chunks = []
        while self.pos < self.n:
            c = self.text[self.pos]
            if c == "\\" and self.pos + 1 < self.n:
                nxt = self.text[self.pos + 1]
                chunks.append({"n": "\n", "t": "\t", "\\": "\\", quote: quote}.get(nxt, "\\" + nxt))
                self.pos += 2
                continue
            if c == quote:
                self.pos += 1
                return "".join(chunks)
            chunks.append(c)
            self.pos += 1
        raise self._error("unterminated string")

    def _bare(self) -> Any:
        start = self.pos
        while self.pos < self.n and self.text[self.pos] not in _BARE_END \
                and not self.text.startswith("//", self.pos):
            self.pos += 1
        raw = self.text[start:self.pos].strip()
        if not raw:
            raise self._error("expected a value")
        return _coerce(raw)


def _coerce(raw: str) -> Any:
    low = raw.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "none"):
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


def _deep_merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def loads(text: str) -> dict:
    """Parse HOCON-style text into a plain dict."""
    return _Parser(text).parse()


def load(path: str) -> dict:
    with open(path, "r") as f:
        return loads(f.read())


def parse_value(raw: str) -> Any:
    """Parse a single CLI override value (HOCON value syntax)."""
    raw = raw.strip()
    if raw.startswith(("[", "{", "\"", "'")):
        return _Parser(raw)._value()
    return _coerce(raw)


def apply_overrides(conf: dict, overrides: list[str]) -> dict:
    """Apply ``dotted.path=value`` CLI overrides in place.

    Mirrors the reference CLI: ``python train.py --conf FILE key=value ...``
    (reference README.md:53).
    """
    for item in overrides:
        if "=" not in item:
            raise HoconError(f"override {item!r} must look like key=value")
        key, _, raw = item.partition("=")
        value = parse_value(raw)
        node = conf
        parts = key.strip().split(".")
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = {}
                node[part] = nxt
            node = nxt
        node[parts[-1]] = value
    return conf
