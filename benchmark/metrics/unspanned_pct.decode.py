"""unspanned_pct.decode (program span): 100 x the time of the window's
``decode.call`` spans (each a whole ``decode_flac`` call) that no child
span covers, over their whole time: host work the tracing does not name."""

from harness.program import arm, unspanned_pct  # noqa: F401


def read(run):
    return unspanned_pct(run, "decode.call")
