"""Device idle share over a traced span of whole train steps: 1 - busy / wall (%)."""

from benchmark.readers import idle_share as read  # noqa: F401
