"""`--config ktwe.yaml`: a main's flags from one section of the KTWE knob
file.

The port's copy of the restricted YAML reader of the JAX package
(autopilot/knobs.py: `_scalar`, `_strip_comment`, `_mini_yaml`): two
levels, component sections of scalar `key: value` leaves, no PyYAML. The
JAX package validates each key against its knob registry; the port
validates it against the main's own parser, so a key of the section that
the main has no flag for is an error naming it (never dropped), and flags
on the command line win over the file.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Sequence

# The knob file's component sections (autopilot/knobs.py `_COMPONENTS`).
COMPONENTS = ("serve", "router", "frontdoor", "autoscaler", "replay")


def _scalar(text: str) -> Any:
    t = text.strip()
    if t in ("", "~", "null", "None"):
        return None
    low = t.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if (t.startswith('"') and t.endswith('"')) or \
            (t.startswith("'") and t.endswith("'")):
        return t[1:-1]
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    return t


def _strip_comment(line: str) -> str:
    """Drop a trailing `#` comment, respecting quotes (a token holding
    `#` is not cut)."""
    quote: Optional[str] = None
    for i, ch in enumerate(line):
        if quote is not None:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return line[:i]
    return line


def _mini_yaml(text: str) -> Dict[str, Dict[str, Any]]:
    """Two levels, scalar leaves: the shape the knob file has."""
    out: Dict[str, Dict[str, Any]] = {}
    section: Optional[str] = None
    for i, raw in enumerate(text.splitlines(), start=1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, sep, value = line.strip().partition(":")
        if not sep:
            raise ValueError(f"line {i}: expected 'key: value'")
        if indent == 0:
            if value.strip():
                raise ValueError(f"line {i}: top level must be component "
                                 f"sections, got a scalar")
            section = key.strip()
            out[section] = {}
        else:
            if section is None:
                raise ValueError(f"line {i}: indented key outside a "
                                 f"component section")
            out[section][key.strip()] = _scalar(value)
    return out


def load_config(path: str) -> Dict[str, Dict[str, Any]]:
    """{component: {key: value}} of a knob file; an unknown section is a
    ValueError."""
    with open(path, "r", encoding="utf-8") as f:
        raw = _mini_yaml(f.read())
    for component in raw:
        if component not in COMPONENTS:
            raise ValueError(f"{path}: unknown component section "
                             f"{component!r} (known: {list(COMPONENTS)})")
    return raw


def _config_path(argv: Sequence[str]) -> str:
    for i, a in enumerate(argv):
        if a == "--config" and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith("--config="):
            return a.split("=", 1)[1]
    return ""


def _cast(action: argparse.Action, key: str, value: Any) -> Any:
    if isinstance(action, argparse._AppendAction):
        # A repeatable flag takes a list; a scalar value is a one-item
        # list, as the JAX knob registry's strlist cast makes it.
        items = value if isinstance(value, (list, tuple)) else [value]
        return [_cast_one(action, key, v) for v in items if v is not None]
    return _cast_one(action, key, value)


def _cast_one(action: argparse.Action, key: str, value: Any) -> Any:
    if action.nargs == 0:                     # store_true / store_false
        if not isinstance(value, bool):
            raise ValueError(f"{key}: expected true or false, got "
                             f"{value!r}")
        return value
    if action.choices and isinstance(value, bool):
        # The reader reads a bare off/on/yes/no as a boolean: it means the
        # on/off or yes/no choice (`disagg: off` is "off"), as the JAX
        # knob registry's cast takes it.
        for truthy, falsy in (("on", "off"), ("yes", "no")):
            if truthy in action.choices or falsy in action.choices:
                value = truthy if value else falsy
                break
    if value is not None and action.type is not None:
        if action.type in (int, float) and isinstance(value, bool):
            raise ValueError(f"{key}: expected a number, got {value!r}")
        try:
            value = action.type(value)
        except (TypeError, ValueError):
            raise ValueError(f"{key}: {value!r} is not a valid "
                             f"{action.type.__name__}") from None
    if action.choices and value not in action.choices:
        # set_defaults would take it unchecked.
        raise ValueError(f"{key}: {value!r} not in {list(action.choices)}")
    return value


def parse_with_config(parser: argparse.ArgumentParser, component: str,
                      argv: Optional[List[str]]) -> argparse.Namespace:
    """parse_args, with the `component` section of the `--config` file
    (when argv names one) installed as the parser's defaults first, so
    command-line flags win. A key the parser has no flag for, a value its
    flag cannot take, or an unreadable file is a parser error naming it."""
    import sys
    args = list(sys.argv[1:] if argv is None else argv)
    path = _config_path(args)
    if path:
        try:
            section = load_config(path).get(component) or {}
            actions = {a.dest: a for a in parser._actions}
            values = {}
            for key, value in section.items():
                action = actions.get(key)
                if action is None or key in ("help", "config"):
                    raise ValueError(
                        f"{component}.{key} has no flag in this main "
                        f"(not ported, or not a {component} knob)")
                values[key] = _cast(action, f"{component}.{key}", value)
        except (OSError, ValueError) as e:
            parser.error(f"--config {path}: {e}")
        parser.set_defaults(**values)
    return parser.parse_args(args)
