"""serde_json-compatible pretty JSON writer.

Copy of the reference's ``core/json_compat.py``: ``tests/test_torch_host.py``
holds its results equal to the reference's.

The reference store writes ``metadata.json`` with Rust's
``serde_json::to_writer_pretty`` (reference: point-converter/src/metadata.rs:51-53).
To keep our stores byte-identical with stores produced by the reference
converter, this module reproduces:

- serde_json's ``PrettyFormatter`` layout (2-space indent, ``": "`` after
  keys, one element per line, no trailing newline), and
- the ``ryu`` crate's "pretty" shortest-round-trip float formatting that
  serde_json uses for ``f32``/``f64`` values.

Only the subset of JSON the store needs is supported (objects, arrays,
strings, ints, floats, bools).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["format_f32", "format_f64", "dumps_pretty"]


def _shortest_digits(value: float, is_f32: bool) -> tuple[str, int]:
    """Shortest decimal digits + exponent that round-trip to ``value``.

    Returns ``(digits, k)`` with ``value == int(digits) * 10**k`` after
    rounding to the source precision. Uses numpy's Dragon4 (``unique=True``),
    which produces the same shortest correctly-rounded representation as the
    ryu algorithm used by serde_json.
    """
    v = np.float32(value) if is_f32 else np.float64(value)
    s = np.format_float_scientific(v, unique=True, trim="-")
    # e.g. "1.2345e-03", "1e+16", "0e+00"
    mantissa, _, exp = s.partition("e")
    exp_i = int(exp)
    mantissa = mantissa.replace(".", "")
    # value = int(mantissa) * 10**(exp_i - (len(mantissa) - 1))
    k = exp_i - (len(mantissa) - 1)
    # strip trailing zeros (dragon4 with trim='-' shouldn't produce them,
    # except for the single "0")
    while len(mantissa) > 1 and mantissa.endswith("0"):
        mantissa = mantissa[:-1]
        k += 1
    return mantissa, k


def _format_ryu_pretty(value: float, is_f32: bool) -> str:
    """Format a finite float the way ryu's pretty printer does.

    Given shortest digits ``d`` and exponent ``k`` (value = d * 10^k), with
    ``kk = len(d) + k`` (position of the decimal point):

    - ``k >= 0 and kk <= 16``  -> "ddd[000].0"      (integer-valued)
    - ``0 < kk <= 16``         -> "dd.ddd"           (point inside digits)
    - ``-5 < kk <= 0``         -> "0.000ddd"         (small magnitude)
    - otherwise                -> "d.ddde±k" / "dek" (exponent notation)
    """
    if value == 0.0:
        return "-0.0" if math.copysign(1.0, value) < 0 else "0.0"

    sign = "-" if value < 0 else ""
    digits, k = _shortest_digits(abs(value), is_f32)
    n = len(digits)
    kk = n + k

    if k >= 0 and kk <= 16:
        return f"{sign}{digits}{'0' * k}.0"
    if 0 < kk <= 16:
        return f"{sign}{digits[:kk]}.{digits[kk:]}"
    if -5 < kk <= 0:
        return f"{sign}0.{'0' * -kk}{digits}"
    # exponent notation; exponent printed for d.ddd * 10^(kk-1)
    e = kk - 1
    if n == 1:
        return f"{sign}{digits}e{e}"
    return f"{sign}{digits[0]}.{digits[1:]}e{e}"


def format_f32(value: float) -> str:
    """serde_json-compatible text for an ``f32`` value."""
    v = float(np.float32(value))
    if math.isnan(v) or math.isinf(v):
        return "null"  # serde_json writes null for non-finite
    return _format_ryu_pretty(v, is_f32=True)


def format_f64(value: float) -> str:
    """serde_json-compatible text for an ``f64`` value."""
    if math.isnan(value) or math.isinf(value):
        return "null"
    return _format_ryu_pretty(value, is_f32=False)


class F32(float):
    """Marker type: a float that must be serialized with f32 precision."""


def _escape(s: str) -> str:
    out = []
    for ch in s:
        if ch == '"':
            out.append('\\"')
        elif ch == "\\":
            out.append("\\\\")
        elif ord(ch) < 0x20:
            mapping = {"\b": "\\b", "\f": "\\f", "\n": "\\n", "\r": "\\r", "\t": "\\t"}
            out.append(mapping.get(ch, f"\\u{ord(ch):04x}"))
        else:
            out.append(ch)
    return "".join(out)


def _write(value, indent: int, out: list[str]) -> None:
    pad = "  " * indent
    child_pad = "  " * (indent + 1)
    if isinstance(value, dict):
        if not value:
            out.append("{}")
            return
        out.append("{\n")
        for i, (key, val) in enumerate(value.items()):
            if i:
                out.append(",\n")
            out.append(f'{child_pad}"{_escape(key)}": ')
            _write(val, indent + 1, out)
        out.append(f"\n{pad}}}")
    elif isinstance(value, (list, tuple)):
        if len(value) == 0:
            out.append("[]")
            return
        out.append("[\n")
        for i, val in enumerate(value):
            if i:
                out.append(",\n")
            out.append(child_pad)
            _write(val, indent + 1, out)
        out.append(f"\n{pad}]")
    elif isinstance(value, bool):
        out.append("true" if value else "false")
    elif isinstance(value, F32) or isinstance(value, np.float32):
        out.append(format_f32(float(value)))
    elif isinstance(value, float):
        out.append(format_f64(value))
    elif isinstance(value, (int, np.integer)):
        out.append(str(int(value)))
    elif isinstance(value, str):
        out.append(f'"{_escape(value)}"')
    elif value is None:
        out.append("null")
    else:
        raise TypeError(f"unsupported JSON value type: {type(value)!r}")


def dumps_pretty(value) -> str:
    """Serialize like ``serde_json::to_string_pretty`` (no trailing newline)."""
    out: list[str] = []
    _write(value, 0, out)
    return "".join(out)
