"""md5_hidden_pct (program counter): the share of the STREAMINFO MD5's work
the caller did not wait for, 100 x (1 - the ``session.md5`` spans' total /
the counter ``session.md5_hash_ns``) over the window. The hash runs on a
worker thread from the WAV's parse, the counter sums each job's own time,
and the span is the calling thread's wait for the digest before STREAMINFO
is written. Both totals go to stderr. A program without the counter (the
hash on the calling thread) gives None."""

import sys

from harness.program import arm, counts, total_ms, totals  # noqa: F401


def read(run):
    c, t = counts(run), totals(run)
    if not c or not c.get("session.md5_hash_ns") or t is None:
        return None
    hash_ms = c["session.md5_hash_ns"] / 1e6
    wait_ms = total_ms(t, "session.md5")
    print(f"md5_hidden_pct: waited {wait_ms:.3f} ms for {hash_ms:.3f} ms of hashing",
          file=sys.stderr)
    return 100.0 * (1.0 - wait_ms / hash_ms)
