"""Typed YAML config, the port of `gsattack/utils/config.py`:

  * scene composition: `configs/config.yaml` + `configs/scene/<name>.yaml`
    merged under the `scene` key (Hydra's defaults list), and
    `scene=<name>` in the overrides picks the scene file;
  * `${dotted.path}` interpolation across the merged tree and
    `${now:%fmt}` timestamps;
  * dotlist overrides `a.b=c`, each value read as a YAML document.

The YAML is read by the small reader below, never by PyYAML: block
mappings and lists (`- scene: toy`), flow lists and mappings (`[color]`,
`[0.0, 1.0]`), single- and double-quoted and plain scalars, and comments.
Plain scalars resolve as PyYAML's YAML 1.1 resolver resolves them
(`yaml.safe_load`, which the JAX package uses): `1.6e-6` is a float but
`1e-3` a string, `yes` / `off` are booleans, `0x10`, `010` (octal) and
`1_000` integers, `~` and `null` None, `2024-01-02` a date. Anchors,
tags, explicit keys (`? a`), single-pair mappings in flow lists
(`[a: 1]`), block scalars (`|`, `>`) and multi-line plain scalars are not
read:
the reader raises `YamlError`, and an override value it cannot read stays
a string, as the JAX package keeps a value PyYAML cannot read.
"""

from __future__ import annotations

import datetime as dt
import os
import re
from datetime import datetime
from typing import Any, Optional, Sequence

_INTERP = re.compile(r"\$\{([^}]+)\}")


class YamlError(ValueError):
    """A YAML text the reader cannot read."""


# ---- scalar resolution (PyYAML's YAML 1.1 implicit resolvers) -------------

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
_TIMESTAMP = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])-(?P<month>[0-9][0-9]?)
                        -(?P<day>[0-9][0-9]?)
                        (?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9])
                        :(?P<second>[0-9][0-9])(?:\.(?P<fraction>[0-9]*))?
                        (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
                        (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)
# The implicit resolver's pattern is stricter than the constructor's: a
# date alone needs two-digit month and day.
_TIMESTAMP_IMPLICIT = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                                 |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                                 (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9]
                                 (?:\.[0-9]*)?
                                 (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)


def _sexagesimal(parts: list, zero):
    value, base = zero, 1
    for digit in reversed(parts):
        value += digit * base
        base *= 60
    return value


def _to_int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
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
    if ":" in value:
        return sign * _sexagesimal([int(p) for p in value.split(":")], 0)
    return sign * int(value)


def _to_float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal([float(p) for p in value.split(":")], 0.0)
    return sign * float(value)


def _to_timestamp(text: str):
    m = _TIMESTAMP.match(text).groupdict()
    year, month, day = int(m["year"]), int(m["month"]), int(m["day"])
    if not m["hour"]:
        return dt.date(year, month, day)
    fraction = int((m["fraction"] or "")[:6].ljust(6, "0"))
    tz = None
    if m["tz_sign"]:
        delta = dt.timedelta(hours=int(m["tz_hour"]), minutes=int(m["tz_minute"] or 0))
        tz = dt.timezone(-delta if m["tz_sign"] == "-" else delta)
    elif m["tz"]:
        tz = dt.timezone.utc
    return dt.datetime(year, month, day, int(m["hour"]), int(m["minute"]),
                       int(m["second"]), fraction, tzinfo=tz)


def resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar's value under the YAML 1.1 resolvers, in
    PyYAML's order: bool, float, int, null, timestamp, else the string."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        return _to_float(text)
    if _INT.match(text):
        return _to_int(text)
    if _NULL.match(text):
        return None
    if _TIMESTAMP_IMPLICIT.match(text):
        return _to_timestamp(text)
    return text


# ---- the reader -------------------------------------------------------------

_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
            "P": "\u2029"}
_HEX = {"x": 2, "u": 4, "U": 8}
_FLOW_END = ",[]{}"


class _Line:
    __slots__ = ("indent", "text", "num")

    def __init__(self, indent: int, text: str, num: int):
        self.indent, self.text, self.num = indent, text, num


def _quoted(text: str, i: int) -> tuple[str, int]:
    """The quoted scalar starting at text[i] -> (value, index past it)."""
    q, out, i = text[i], [], i + 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == '"':
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            e = text[i + 1 : i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX:
                n = _HEX[e]
                code = text[i + 2 : i + 2 + n]
                if len(code) != n or not re.fullmatch(r"[0-9a-fA-F]+", code):
                    raise YamlError(f"bad escape in {text!r}")
                out.append(chr(int(code, 16)))
                i += 2 + n
            else:
                raise YamlError(f"unknown escape \\{e} in {text!r}")
            continue
        out.append(c)
        i += 1
    raise YamlError(f"unterminated quoted scalar in {text!r}")


def _strip_comment(text: str) -> str:
    """The line without its comment: a '#' at the start or after a space,
    outside quotes."""
    i = 0
    while i < len(text):
        c = text[i]
        if c in "'\"" and (i == 0 or text[i - 1] in " \t[{,:-"):
            try:
                _, i = _quoted(text, i)
                continue
            except YamlError:
                pass
        if c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _check_plain_start(text: str) -> None:
    c = text[:1]
    if c and (c in "[]{},#&*!|>'\"%@`" or (c in "-?:" and text[1:2] in ("", " ", "\t"))):
        raise YamlError(f"cannot read {text!r}: it starts with an indicator")


class _Flow:
    """Recursive descent over one flow collection or scalar."""

    def __init__(self, text: str):
        self.text, self.i = text, 0

    def ws(self) -> None:
        while self.i < len(self.text) and self.text[self.i] in " \t":
            self.i += 1

    def node(self) -> Any:
        self.ws()
        c = self.text[self.i : self.i + 1]
        if c == "[":
            return self.seq()
        if c == "{":
            return self.mapping()
        if c in ("'", '"'):
            value, self.i = _quoted(self.text, self.i)
            return value
        return self.plain()

    def plain(self) -> Any:
        start = self.i
        while self.i < len(self.text):
            c = self.text[self.i]
            if c in _FLOW_END:
                break
            if c == ":" and self.text[self.i + 1 : self.i + 2] in ("", " ", "\t", *_FLOW_END):
                break
            self.i += 1
        text = self.text[start : self.i].strip()
        if not text:
            raise YamlError(f"empty entry at {start} in {self.text!r}")
        _check_plain_start(text)
        return resolve_plain(text)

    def expect(self, c: str) -> None:
        self.ws()
        if self.text[self.i : self.i + 1] != c:
            raise YamlError(f"expected {c!r} at {self.i} in {self.text!r}")
        self.i += 1

    def seq(self) -> list:
        self.expect("[")
        out = []
        while True:
            self.ws()
            if self.text[self.i : self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.node())
            self.ws()
            if self.text[self.i : self.i + 1] == ",":
                self.i += 1
            elif self.text[self.i : self.i + 1] != "]":
                raise YamlError(f"expected ',' or ']' in {self.text!r}")

    def mapping(self) -> dict:
        self.expect("{")
        out = {}
        while True:
            self.ws()
            if self.text[self.i : self.i + 1] == "}":
                self.i += 1
                return out
            key = self.node()
            self.ws()
            value = None
            if self.text[self.i : self.i + 1] == ":":
                self.i += 1
                self.ws()
                if self.text[self.i : self.i + 1] not in (",", "}"):
                    value = self.node()
            out[key] = value
            self.ws()
            if self.text[self.i : self.i + 1] == ",":
                self.i += 1
            elif self.text[self.i : self.i + 1] != "}":
                raise YamlError(f"expected ',' or '}}' in {self.text!r}")


def _inline(text: str) -> Any:
    """A value written on one line: a flow collection or a scalar."""
    if text[:1] in ("[", "{", "'", '"'):
        f = _Flow(text)
        value = f.node()
        f.ws()
        if f.i != len(text):
            raise YamlError(f"unexpected {text[f.i:]!r} after {text[:f.i]!r}")
        return value
    if text[:1] in ("|", ">"):
        raise YamlError(f"block scalars are not read: {text!r}")
    _check_plain_start(text)
    return resolve_plain(text)


def _split_key(text: str) -> Optional[tuple[Any, str]]:
    """`key: rest` -> (key, rest), or None when the line is no mapping
    entry."""
    if text[:1] in ("'", '"'):
        key, i = _quoted(text, 0)
        rest = text[i:].lstrip(" \t")
        if rest[:1] == ":" and rest[1:2] in ("", " ", "\t"):
            return key, rest[1:].strip()
        return None
    if text[:1] in ("[", "{"):
        return None
    for m in re.finditer(r":(?=[ \t]|$)", text):
        key = text[: m.start()].rstrip()
        _check_plain_start(key)
        return resolve_plain(key), text[m.end():].strip()
    return None


def _is_seq_entry(text: str) -> bool:
    return text == "-" or text.startswith(("- ", "-\t"))


class _Block:
    def __init__(self, lines: list[_Line]):
        self.lines, self.pos = lines, 0

    def peek(self) -> Optional[_Line]:
        return self.lines[self.pos] if self.pos < len(self.lines) else None

    def node(self, indent: int) -> Any:
        line = self.peek()
        if _is_seq_entry(line.text):
            return self.seq(line.indent)
        if _split_key(line.text) is not None:
            return self.mapping(line.indent)
        self.pos += 1
        nxt = self.peek()
        if nxt is not None and nxt.indent > indent:
            raise YamlError(f"line {nxt.num}: multi-line plain scalars are not read")
        return _inline(line.text)

    def seq(self, indent: int) -> list:
        out = []
        while (line := self.peek()) is not None and line.indent == indent \
                and _is_seq_entry(line.text):
            rest = line.text[1:]
            body = rest.lstrip(" \t")
            if not body:
                self.pos += 1
                nxt = self.peek()
                out.append(self.node(indent) if nxt is not None and nxt.indent > indent
                           else None)
                continue
            # The entry's content is a node of its own, indented to where
            # it starts: `- scene: toy` opens a mapping at that column.
            self.lines[self.pos] = _Line(indent + 1 + len(rest) - len(body), body, line.num)
            out.append(self.node(indent))
        return out

    def mapping(self, indent: int) -> dict:
        out = {}
        while (line := self.peek()) is not None and line.indent == indent:
            kv = _split_key(line.text)
            if kv is None:
                raise YamlError(f"line {line.num}: expected 'key: value', got {line.text!r}")
            key, rest = kv
            self.pos += 1
            if rest:
                out[key] = _inline(rest)
                continue
            nxt = self.peek()
            if nxt is not None and (nxt.indent > indent or (
                    nxt.indent == indent and _is_seq_entry(nxt.text))):
                out[key] = self.node(indent)
            else:
                out[key] = None
        if (line := self.peek()) is not None and line.indent > indent:
            raise YamlError(f"line {line.num}: bad indentation")
        return out


def parse_yaml(text: str) -> Any:
    """Read one YAML document (the subset the module docstring names)."""
    lines = []
    for num, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise YamlError(f"line {num}: tabs cannot indent YAML")
        body = _strip_comment(body)
        if body:
            lines.append(_Line(len(raw) - len(raw.lstrip(" ")), body, num))
    if lines and lines[0].text == "---":
        lines = lines[1:]
    if not lines:
        return None
    block = _Block(lines)
    value = block.node(-1)
    if block.peek() is not None:
        raise YamlError(f"line {block.peek().num}: unexpected content")
    return value


# ---- the config tree ----------------------------------------------------------


class ConfigNode(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return ConfigNode({k: ConfigNode.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigNode.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> dict:
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


def _lookup(root: dict, dotted: str):
    cur: Any = root
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            raise KeyError(f"interpolation ${{{dotted}}} not found")
        cur = cur[part]
    return cur


def _resolve(obj: Any, root: dict, now: datetime) -> Any:
    if isinstance(obj, dict):
        return {k: _resolve(v, root, now) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve(v, root, now) for v in obj]
    if isinstance(obj, str):

        def repl(m):
            expr = m.group(1)
            if expr.startswith("now:"):
                return now.strftime(expr[4:])
            return str(_resolve(_lookup(root, expr), root, now))

        # Whole-string interpolation keeps the value's type.
        full = _INTERP.fullmatch(obj)
        if full and not full.group(1).startswith("now:"):
            return _resolve(_lookup(root, full.group(1)), root, now)
        return _INTERP.sub(repl, obj)
    return obj


def _parse_override_value(v: str) -> Any:
    try:
        return parse_yaml(v)
    except YamlError:
        return v


def apply_overrides(cfg: dict, overrides: Sequence[str]) -> dict:
    """Hydra-style dotlist overrides: `a.b=c`."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} is not key=value")
        key, val = ov.split("=", 1)
        cur = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = _parse_override_value(val)
    return cfg


def _read(path: str) -> Any:
    with open(path) as f:
        return parse_yaml(f.read())


def load_config(
    config_dir: str = "configs",
    config_name: str = "config",
    scene: Optional[str] = None,
    overrides: Sequence[str] = (),
    now: Optional[datetime] = None,
) -> ConfigNode:
    """Load, compose and interpolate a config tree."""
    cfg = _read(os.path.join(config_dir, f"{config_name}.yaml")) or {}

    # Hydra's defaults list: [{"scene": "maserati"}, "_self_"]
    defaults = cfg.pop("defaults", [])
    default_scene = None
    for d in defaults:
        if isinstance(d, dict) and "scene" in d:
            default_scene = d["scene"]
    scene_name = scene or default_scene
    overrides = list(overrides)
    for ov in list(overrides):
        if ov.startswith("scene=") and "." not in ov.split("=")[0]:
            scene_name = ov.split("=", 1)[1]
            overrides.remove(ov)
    if scene_name:
        scene_path = os.path.join(config_dir, "scene", f"{scene_name}.yaml")
        if os.path.exists(scene_path):
            cfg["scene"] = _read(scene_path) or {}
    apply_overrides(cfg, overrides)
    resolved = _resolve(cfg, cfg, now or datetime.now())
    return ConfigNode.wrap(resolved)
