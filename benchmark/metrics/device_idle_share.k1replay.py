"""Share of the window with no device activity (profiler), in %."""
from benchmark.readers import device_idle_share as read  # noqa: F401
