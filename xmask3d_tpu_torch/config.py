"""Config system: YAML subset -> attribute dict with CLI `KEY VALUE` overrides.

Own copy of `xmask3d_tpu/config.py`. It carries a small parser for the YAML
subset the repo's configs use (block mappings, block lists of scalars, flow
lists and maps, plain and quoted scalars, comments), so loading a config
needs no PyYAML.
"""

from __future__ import annotations

import ast
import copy
import os
import re
from typing import Any, List, Optional, Tuple


class Config(dict):
    """Attribute-accessible dict. Nested dicts are wrapped on access."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
            self[name] = value
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return Config(copy.deepcopy(dict(self), memo))

    def clone(self) -> "Config":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# YAML subset parser
# ---------------------------------------------------------------------------

_INT = re.compile(r"^[-+]?[0-9]+$")
_FLOAT = re.compile(r"^[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?$")


def _scalar(tok: str) -> Any:
    """YAML 1.1 plain/quoted scalar, as PyYAML's safe loader resolves it."""
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        body = tok[1:-1]
        return body.replace("''", "'") if tok[0] == "'" else ast.literal_eval(tok)
    if tok in ("", "~", "null", "Null", "NULL"):
        return None
    if tok in ("true", "True", "TRUE"):
        return True
    if tok in ("false", "False", "FALSE"):
        return False
    if _INT.match(tok):
        return int(tok)
    # YAML 1.1 floats need a dot ("1e-4" stays a string, as in PyYAML)
    if _FLOAT.match(tok) and "." in tok:
        return float(tok)
    return tok


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _flow(text: str, i: int = 0) -> Tuple[Any, int]:
    """Parse a flow collection or scalar starting at text[i]."""
    while text[i] == " ":
        i += 1
    if text[i] in "[{":
        close = "]" if text[i] == "[" else "}"
        is_map = text[i] == "{"
        out: Any = {} if is_map else []
        i += 1
        while True:
            while text[i] in " \n":
                i += 1
            if text[i] == close:
                return out, i + 1
            if is_map:
                j = text.index(":", i)
                key = _scalar(text[i:j])
                val, i = _flow(text, j + 1)
                out[key] = val
            else:
                val, i = _flow(text, i)
                out.append(val)
            while text[i] in " \n":
                i += 1
            if text[i] == ",":
                i += 1
    quote = text[i] if text[i] in "'\"" else None
    j = i + 1 if quote else i
    while j < len(text):
        if quote:
            if text[j] == quote:
                j += 1
                break
        elif text[j] in ",]}":
            break
        j += 1
    return _scalar(text[i:j]), j


def _balanced(s: str) -> bool:
    depth, quote = 0, None
    for ch in s:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth == 0


def parse_yaml(text: str) -> dict:
    """Parse the YAML subset of the repo's configs into plain Python values."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))

    def block(pos: int, indent: int) -> Tuple[Any, int]:
        if lines[pos][1].startswith("- "):
            items = []
            while pos < len(lines) and lines[pos][0] == indent \
                    and lines[pos][1].startswith("- "):
                items.append(_flow(lines[pos][1][2:] + "\n")[0])
                pos += 1
            return items, pos
        out: dict = {}
        while pos < len(lines) and lines[pos][0] == indent:
            body = lines[pos][1]
            key, sep, rest = body.partition(":")
            if not sep:
                raise ValueError(f"unsupported YAML line: {body!r}")
            rest = rest.strip()
            pos += 1
            if rest:
                while not _balanced(rest):
                    rest += "\n" + lines[pos][1]
                    pos += 1
                out[_scalar(key)] = _flow(rest + "\n")[0]
            elif pos < len(lines) and (
                lines[pos][0] > indent
                or (lines[pos][0] == indent and lines[pos][1].startswith("- "))
            ):
                out[_scalar(key)], pos = block(pos, lines[pos][0])
            else:
                out[_scalar(key)] = None
        return out, pos

    if not lines:
        return {}
    value, pos = block(0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"unsupported YAML structure near {lines[pos][1]!r}")
    return value


def load_config(path: str, overrides: Optional[List[str]] = None) -> Config:
    """Load a YAML config, flattening top-level sections one level (the
    behaviour of `xmask3d_tpu.config.load_config`)."""
    with open(path, "r") as f:
        raw = parse_yaml(f.read())
    cfg = Config()
    for key, value in raw.items():
        if isinstance(value, dict):
            for k, v in value.items():
                cfg[k] = v
        else:
            cfg[key] = value
    if "meta_file" in cfg:
        meta_path = cfg["meta_file"]
        if not os.path.isabs(meta_path):
            meta_path = os.path.join(os.path.dirname(path), meta_path)
        with open(meta_path) as f:
            for k, v in parse_yaml(f.read()).items():
                cfg[k] = v
    if overrides:
        merge_overrides(cfg, overrides)
    return cfg


def _decode_value(value: str) -> Any:
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce(new: Any, old: Any, key: str) -> Any:
    if old is None or type(new) is type(old):
        return new
    casts = [(tuple, list), (list, tuple), (int, float), (float, int)]
    for src, dst in casts:
        if isinstance(new, src) and isinstance(old, dst):
            return dst(new)
    raise ValueError(
        f"type mismatch for key {key}: cannot coerce {type(new)} to {type(old)}"
    )


def merge_overrides(cfg: Config, kv_list: List[str]) -> Config:
    """Apply positional `KEY VALUE KEY VALUE ...` overrides in place."""
    if len(kv_list) % 2:
        raise ValueError(f"override list must be even-length: {kv_list}")
    for key, raw in zip(kv_list[0::2], kv_list[1::2]):
        subkeys = key.split(".")
        node = cfg
        for sk in subkeys[:-1]:
            node = getattr(node, sk)
        leaf = subkeys[-1]
        value = _decode_value(raw)
        if leaf in node:
            value = _coerce(value, node[leaf], key)
        node[leaf] = value
    return cfg
