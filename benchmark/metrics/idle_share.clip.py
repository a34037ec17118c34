"""Device idle share over a traced span of whole clips: 1 - profiler busy / wall (%)."""

from benchmark.readers import idle_share as read  # noqa: F401
