"""Strict parsing for the DSML_* environment flags (the port's own copy).

Boolean flags accept 1/true/on/yes and 0/false/off/no (case-insensitive);
mode flags accept their documented vocabulary with the boolean spellings
normalized first. Anything else raises: a typo must not silently select a
default.
"""
from __future__ import annotations

import os

_TRUE = ("1", "true", "on", "yes")
_FALSE = ("0", "false", "off", "no")


def _normalize(raw: str) -> str:
    v = raw.strip().lower()
    if v in _TRUE:
        return "1"
    if v in _FALSE:
        return "0"
    return v


def env_flag(name: str, default: bool) -> bool:
    """Boolean env flag: unset -> default; unrecognized values raise."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    v = _normalize(raw)
    if v == "1":
        return True
    if v == "0":
        return False
    raise ValueError(
        f"{name}={raw!r}: expected a boolean "
        f"({'/'.join(_TRUE)} or {'/'.join(_FALSE)})")


def env_mode(name: str, default: str, choices: tuple) -> str:
    """Mode env flag: unset -> default; boolean spellings normalize to
    '1'/'0'; anything outside ``choices`` raises."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    v = _normalize(raw)
    if v in choices:
        return v
    raise ValueError(f"{name}={raw!r}: expected one of {choices}")
