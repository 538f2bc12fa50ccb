"""Unit parsing (reference: source/toolkits/UnitTk.{h,cpp}).

Parses human size strings ("4K", "1M", "10g", "1GiB", "2TB") to bytes.
Like the reference, bare suffixes K/M/G/T/P/E are base-2 (KiB etc.);
explicit "KB"/"kB" decimal forms are base-10; "KiB" forms are base-2.
"""

from __future__ import annotations

_BASE2 = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40,
          "p": 1 << 50, "e": 1 << 60}
_BASE10 = {"k": 10 ** 3, "m": 10 ** 6, "g": 10 ** 9, "t": 10 ** 12,
           "p": 10 ** 15, "e": 10 ** 18}


class UnitParseError(ValueError):
    pass


def parse_size(value: "str | int | None") -> int:
    """Parse a human size string to a byte count.

    Accepts: plain ints; "<num>" ; "<num>K" (base-2); "<num>KiB" (base-2);
    "<num>KB" (base-10). Case-insensitive. Floats allowed with suffix
    ("1.5G").
    """
    if value is None:
        return 0
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value).strip()
    if not s:
        return 0
    low = s.lower()
    num_end = 0
    while num_end < len(low) and (low[num_end].isdigit() or low[num_end] in "."):
        num_end += 1
    num_str, suffix = low[:num_end], low[num_end:].strip()
    if not num_str:
        raise UnitParseError(f"no numeric part in size string: {value!r}")
    num = float(num_str) if "." in num_str else int(num_str)
    if not suffix:
        return int(num)
    mult_map = _BASE2
    if suffix.endswith("ib"):  # KiB/MiB/...
        suffix = suffix[:-2]
        mult_map = _BASE2
    elif suffix.endswith("b"):  # KB/MB/... => base-10; bare "b" = bytes
        suffix = suffix[:-1]
        mult_map = _BASE10
        if not suffix:
            return int(num)
    if suffix not in mult_map:
        raise UnitParseError(f"unknown size suffix in {value!r}")
    return int(num * mult_map[suffix])


def parse_uint_list(value: str) -> "list[int]":
    """Parse comma-separated integer list ("0,1,2")."""
    if not value:
        return []
    return [int(part) for part in str(value).split(",") if part.strip() != ""]
