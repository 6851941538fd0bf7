"""The hardened environment-knob parser (copy of `mxnet_tpu/_env.py`).

Every numeric ``MXTPU_*`` environment read in the port routes through
this module. The rules are the JAX package's, so a knob means the same
thing to both packages:

  * strtol/strtod parity — leading C whitespace and an optional sign are
    accepted, ANYTHING after the number (trailing whitespace included)
    is malformed; no underscores, no hex, no ``inf``/``nan``;
  * a malformed or out-of-bounds value falls back to the caller's
    default with ONE warning per key per process (never an exception —
    import must survive any environment);
  * bounds are part of the parse: a value outside ``[minimum, maximum]``
    is as malformed as ``"fast"``.

`parse_int` / `parse_float` are the strict building blocks (raise
``ValueError``) for callers where silent defaulting would be wrong.
"""
from __future__ import annotations

import logging
import os
import re

__all__ = ["env_int", "env_float", "env_ms", "parse_int", "parse_float"]

# C strtol discipline: isspace() whitespace, optional sign, decimal
# digits, endptr at end-of-string (trailing ANYTHING = malformed).
_INT_RE = re.compile(r"[ \t\n\r\f\v]*[+-]?[0-9]+")
# strtod subset: decimal forms with optional fraction/exponent; no
# inf/nan (a knob must be finite), no hex floats, no underscores.
_FLOAT_RE = re.compile(
    r"[ \t\n\r\f\v]*[+-]?(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)"
    r"(?:[eE][+-]?[0-9]+)?")

_warned = set()          # keys already warned about (one warning per key)


def _warn(key, raw, reason, default):
    if key in _warned:
        return
    _warned.add(key)
    logging.getLogger("mxnet_tpu_torch.env").warning(
        "ignoring malformed %s=%r (%s); using default %s",
        key, raw, reason, default)


def parse_int(raw, key="value"):
    """Strict strtol-parity int parse of an already-fetched string;
    raises ``ValueError`` naming `key` on any malformed form."""
    if raw is None or not _INT_RE.fullmatch(str(raw)):
        raise ValueError(f"{key}={raw!r} is not a strtol-parseable "
                         f"integer")
    return int(str(raw))


def parse_float(raw, key="value"):
    """Strict strtod-parity finite-float parse; raises ``ValueError``."""
    if raw is None or not _FLOAT_RE.fullmatch(str(raw)):
        raise ValueError(f"{key}={raw!r} is not a strtod-parseable "
                         f"finite float")
    return float(str(raw))


def _bounded(key, raw, value, default, minimum, maximum):
    if minimum is not None and value < minimum:
        _warn(key, raw, f"below minimum {minimum}", default)
        return default
    if maximum is not None and value > maximum:
        _warn(key, raw, f"above maximum {maximum}", default)
        return default
    return value


def env_int(key, default, minimum=None, maximum=None):
    """``int(os.environ[key])`` with the house rules: strtol parity,
    bounds, one-warning fallback to `default` (returned verbatim when
    the key is unset — it may be ``None``)."""
    raw = os.environ.get(key)
    if raw is None:
        return default
    try:
        value = parse_int(raw, key)
    except ValueError as e:
        _warn(key, raw, str(e), default)
        return default
    return _bounded(key, raw, value, default, minimum, maximum)


def env_float(key, default, minimum=None, maximum=None):
    """``float(os.environ[key])`` with the house rules (finite only)."""
    raw = os.environ.get(key)
    if raw is None:
        return default
    try:
        value = parse_float(raw, key)
    except ValueError as e:
        _warn(key, raw, str(e), default)
        return default
    return _bounded(key, raw, value, default, minimum, maximum)


def env_ms(key, default):
    """A millisecond knob: non-negative finite float, same fallback
    rules (0 conventionally disables the feature)."""
    return env_float(key, default, minimum=0.0)
