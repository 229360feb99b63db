"""kernels_roofline.encode (device trace): the least time the window's
encode work needs on the card (``harness/roofline.py``, counted from the
algorithm at the items' shapes), over the device time of every non-copy
device operation in the traced window."""

from harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "kernels_roofline.encode")
