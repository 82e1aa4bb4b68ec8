"""Federation algebra (fix-mode width rates, counted aggregation)."""

from .core import combine_counted, to_width_rates  # noqa: F401
