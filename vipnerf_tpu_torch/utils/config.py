"""Config helpers (counterpart of vipnerf_tpu/utils/config.py `dict_diff`)."""

from typing import Any


def dict_diff(old: Any, new: Any, prefix: str = "") -> list:
    """Minimal recursive diff: list of 'path: old -> new' strings."""
    diffs = []
    if isinstance(old, dict) and isinstance(new, dict):
        for key in sorted(set(old) | set(new)):
            p = f"{prefix}.{key}" if prefix else str(key)
            if key not in old:
                diffs.append(f"{p}: <absent> -> {new[key]!r}")
            elif key not in new:
                diffs.append(f"{p}: {old[key]!r} -> <absent>")
            else:
                diffs.extend(dict_diff(old[key], new[key], p))
    elif old != new:
        diffs.append(f"{prefix}: {old!r} -> {new!r}")
    return diffs
