"""Kubernetes resource-quantity parsing (the port's own copy of
`k8s_scheduler_tpu/utils/quantity.py parse_quantity`; the port imports
nothing of the JAX package).

The reference family parses quantities with `k8s.io/apimachinery`'s
`resource.Quantity` (suffixes m, k/M/G/T/P/E, Ki/Mi/Gi/Ti/Pi/Ei, scientific
notation). Scheduling only needs a scalar ordering + arithmetic, so we
normalize every quantity to a float:

- cpu-like quantities: parsed to *millicores* when `as_millis=True`
  (the scheduler's internal cpu unit, matching upstream MilliCPU).
- everything else: absolute value (bytes for memory).

Expected upstream location (fork mount was empty, [UNVERIFIED] per
SURVEY.md): vendored apimachinery `pkg/api/resource/quantity.go`.
"""

from __future__ import annotations

_BIN = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DEC = {
    "n": 1e-9,
    "u": 1e-6,
    "m": 1e-3,
    "": 1.0,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
}


def parse_quantity(q: "str | int | float", as_millis: bool = False) -> float:
    """Parse a k8s quantity string (or passthrough number) to a float.

    >>> parse_quantity("100m", as_millis=True)
    100.0
    >>> parse_quantity("2", as_millis=True)
    2000.0
    >>> parse_quantity("1Gi")
    1073741824.0
    """
    if isinstance(q, (int, float)):
        val = float(q)
        return val * 1000.0 if as_millis else val
    s = q.strip()
    if not s:
        raise ValueError("empty quantity")
    for suf, mult in _BIN.items():
        if s.endswith(suf):
            return float(s[: -len(suf)]) * mult * (1000.0 if as_millis else 1.0)
    # Single-char decimal suffix. Scientific notation ("1e3") ends in a
    # digit, so it never collides; a bare trailing e/E ("5E" = 5 exa) does
    # not parse as a float, which the try below distinguishes.
    if len(s) > 1 and s[-1] in _DEC:
        try:
            val = float(s[:-1]) * _DEC[s[-1]]
        except ValueError:
            val = float(s)
    else:
        val = float(s)
    return val * 1000.0 if as_millis else val

