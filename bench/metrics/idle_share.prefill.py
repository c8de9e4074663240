"""Per cent of the traced window in which the card ran nothing."""
from bench.readers import idle_share as read  # noqa: F401
