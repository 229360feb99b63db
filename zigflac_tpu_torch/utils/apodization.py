"""The port's encoder configuration: ``utils/config.py``'s (a verbatim copy
of the JAX package's) with the list of LPC apodization windows added.

``apodization`` names the windows the LPC analysis tries on every plane,
as the flac tool's ``-A`` does: ``tukey(P)``, and ``partial_tukey(N)`` and
``punchout_tukey(N)``, each of which gives its N parts. The cheapest
window's candidate wins. The default, the one Q8 Tukey(0.5) window, writes
the JAX package's bytes; ``flac -8``'s list is ``("tukey(0.5)",
"partial_tukey(2)", "punchout_tukey(3)")``, six windows. ``ops/lpc.py``
builds each window's Q8 values.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple, Tuple

from . import config


class Window(NamedTuple):
    """One apodization window: ``tukey`` (``param`` its taper fraction), or
    part ``part`` of ``parts`` of ``partial_tukey`` / ``punchout_tukey``."""

    kind: str
    param: float = 0.5
    parts: int = 1
    part: int = 0

    @property
    def label(self) -> str:
        """The window's name in the tally of the windows that won."""
        if self.kind == "tukey":
            return f"tukey({self.param:g})"
        return f"{self.kind}({self.parts})[{self.part}]"


TUKEY_HALF = Window("tukey")
DEFAULT_APODIZATION = ("tukey(0.5)",)
MAX_WINDOWS = 32  # libFLAC's limit on apodizations
# libFLAC 1.3's defaults for partial_tukey(n) and punchout_tukey(n): the
# parts' overlap fraction, and the Tukey taper fraction of each part
PART_OVERLAP = {"partial_tukey": 0.1, "punchout_tukey": 0.2}
PART_TAPER = 0.2

_NAME = re.compile(r"tukey\(([0-9.eE+-]+)\)|(partial_tukey|punchout_tukey)\((\d+)\)")


def _parse_window(name: str) -> Tuple[Window, ...]:
    m = _NAME.fullmatch(name) if isinstance(name, str) else None
    if m is None:
        raise ValueError(f"unknown apodization window {name!r}: tukey(P), partial_tukey(N) "
                         "or punchout_tukey(N)")
    if m.group(1) is not None:
        try:
            p = float(m.group(1))
        except ValueError:
            p = -1.0
        if not 0.0 < p <= 1.0:
            raise ValueError(f"apodization {name!r}: the taper fraction must be in (0, 1]")
        return (Window("tukey", p),)
    kind, parts = m.group(2), int(m.group(3))
    if not 2 <= parts <= MAX_WINDOWS:
        raise ValueError(f"apodization {name!r}: {kind} takes 2..{MAX_WINDOWS} parts")
    return tuple(Window(kind, PART_TAPER, parts, j) for j in range(parts))


@lru_cache(maxsize=64)
def parse_windows(names: Tuple[str, ...]) -> Tuple[Window, ...]:
    """The windows a configuration's ``apodization`` names, in order: a
    group (``partial_tukey(2)``) gives each of its parts. Raises
    ValueError on an unknown name or a count outside 1..32."""
    out = tuple(w for name in names for w in _parse_window(name))
    if not 1 <= len(out) <= MAX_WINDOWS:
        raise ValueError(f"apodization gives {len(out)} windows, expected 1..{MAX_WINDOWS}")
    return out


@dataclass(frozen=True)
class EncoderConfig(config.EncoderConfig):
    apodization: Tuple[str, ...] = DEFAULT_APODIZATION

    def __post_init__(self) -> None:
        super().__post_init__()
        names = self.apodization
        names = (names,) if isinstance(names, str) else tuple(names)
        object.__setattr__(self, "apodization", names)
        parse_windows(names)


def windows_of(cfg: config.EncoderConfig) -> Tuple[Window, ...]:
    """The windows of ``cfg``; the one default window for a configuration
    without the setting (``utils/config.py``'s)."""
    return parse_windows(getattr(cfg, "apodization", DEFAULT_APODIZATION))
