"""device_idle.encode (device trace): the share of the traced window in
which no device operation ran, 100 * (1 - busy / window)."""

from harness.readers import idle_pct as read  # noqa: F401
