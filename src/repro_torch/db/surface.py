"""API-surface snapshot generator for ``repro_torch.db``.

A copy of ``repro/db/surface.py`` pointed at the port's facade.  Prints
one line per public name — functions/methods with their signatures,
dataclasses with their fields — in a stable order:

    PYTHONPATH=src python -m repro_torch.db.surface

``tests/test_torch_surface.py`` holds every line to the reference's
committed ``docs/api_surface.txt`` (``repro.`` read as
``repro_torch.``), or to its list of known differences, each tagged
with the ROADMAP item that closes it.
"""
from __future__ import annotations

import dataclasses
import inspect


def _describe_callable(qualname: str, fn) -> str:
    return f"{qualname}{inspect.signature(fn)}"


def _describe_class(name: str, cls) -> list[str]:
    lines = []
    if dataclasses.is_dataclass(cls):
        fields = ", ".join(
            f"{f.name}: {f.type}" for f in dataclasses.fields(cls))
        lines.append(f"{name}({fields})")
    elif hasattr(cls, "_fields"):          # NamedTuple
        fields = ", ".join(cls._fields)
        lines.append(f"{name}({fields})")
    else:
        lines.append(f"{name}")
    for attr in sorted(vars(cls)):
        if attr.startswith("_") and attr not in ("__enter__", "__exit__"):
            continue
        member = inspect.getattr_static(cls, attr)
        if isinstance(member, property):
            lines.append(f"{name}.{attr} [property]")
        elif isinstance(member, (classmethod, staticmethod)):
            lines.append(_describe_callable(f"{name}.{attr}",
                                            member.__func__))
        elif callable(member):
            lines.append(_describe_callable(f"{name}.{attr}", member))
    return lines


def generate() -> str:
    """The snapshot text — one sorted line per public name."""
    import repro_torch.db as db
    lines: list[str] = []
    for name in sorted(db.__all__):
        obj = getattr(db, name)
        if inspect.isclass(obj):
            lines.extend(_describe_class(name, obj))
        elif callable(obj):
            lines.append(_describe_callable(name, obj))
        else:
            lines.append(name)
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    print(generate(), end="")
