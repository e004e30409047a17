"""The metric names of the port's reliability modules: re-exported from
`telemetry/names.py`, the one registry of the port's names (the
reference's strings, so a dashboard reads either package)."""
from ..telemetry.names import *  # noqa: F401,F403
