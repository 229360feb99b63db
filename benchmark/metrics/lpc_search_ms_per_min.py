"""lpc_search_ms_per_min (program span): stream milliseconds of the LPC
window search (``utils/stages.py`` ``SEARCH``: one pair of CUDA events a
search, from the lag sums to the chosen window's Rice estimate, over every
window the configuration lists), summed over the window's batches, per
minute of audio encoded. The LPC subframes each window won, tallied on the
card, and the ``lpc.window_evals`` counter (planes x windows) go to
stderr. A program without the interval gives None."""

import sys

from harness.readers import per_minute


def _stages():
    from zigflac_tpu_torch.utils import stages

    return stages if hasattr(stages, "SEARCH") else None


def arm(run):
    stages = _stages()
    if stages is not None and run.cuda:
        stages.SEARCH = []
        stages.WINDOW_WINS = {}


def read(run):
    stages = _stages()
    if stages is None or not stages.SEARCH or not run.done:
        return None
    ms = sum(a.elapsed_time(b) for a, b in stages.SEARCH)
    evals = (stages.COUNTS or {}).get("lpc.window_evals")
    print(f"lpc_search_ms_per_min: {len(stages.SEARCH)} searches, {ms:.3f} ms, "
          f"lpc.window_evals {evals}", file=sys.stderr)
    for labels, tally in (stages.WINDOW_WINS or {}).items():
        won = tally.tolist()
        print("lpc_search_ms_per_min: LPC subframes won by window: " + ", ".join(
            f"{w} {n}" for w, n in zip(labels, won)) + f" (of {sum(won)})", file=sys.stderr)
    return per_minute(run, ms)
