"""decode_xrt (host clock): seconds of audio of every stream decoded in the
window, frame CRCs and the STREAMINFO MD5 checked, over the window's wall
seconds."""

from harness.readers import rate as read  # noqa: F401
