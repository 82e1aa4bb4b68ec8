"""Round execution on one GPU."""

from .round_engine import RoundEngine, client_seed  # noqa: F401
