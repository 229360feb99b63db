"""frames_unpacked_pct (program counter): 100 x the rows the device encoded
from frames that the PCM unpack kernel made on the card out of the WAV's own
bytes (counter ``pipeline.frames_unpacked``), over every row it encoded
(``pipeline.frames_encoded``), dispatches and re-encodes alike, over the
window. A program without the counter gives None."""

import sys

from harness.program import arm, counts  # noqa: F401


def read(run):
    c = counts(run)
    if not c or "pipeline.frames_unpacked" not in c or not c.get("pipeline.frames_encoded"):
        return None
    unpacked, encoded = c["pipeline.frames_unpacked"], c["pipeline.frames_encoded"]
    print(f"frames_unpacked_pct: {unpacked} of {encoded} rows encoded from unpacked frames",
          file=sys.stderr)
    return 100.0 * unpacked / encoded
