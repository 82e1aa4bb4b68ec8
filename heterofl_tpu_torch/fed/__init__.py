"""Federation algebra (per-round rates, width rates, counted aggregation)."""

from .core import (ROUND_RATE_SALT, combine_counted, round_rates,  # noqa: F401
                   sample_model_rates, to_width_rates, validate_width_geometry)
