"""encode_xrt (host clock): seconds of audio of every item whose FLAC came
back in the window, over the window's wall seconds."""

from harness.readers import rate as read  # noqa: F401
