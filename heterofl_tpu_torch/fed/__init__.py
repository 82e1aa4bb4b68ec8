"""Federation algebra (per-round rates, width rates, counted aggregation,
the sliced sub-models) and the sliced strategy's host-side twin."""

from .core import (ROUND_RATE_SALT, active_indices, combine_counted,  # noqa: F401
                   embed_sliced, extract_sliced, level_index_map, round_rates,
                   sample_model_rates, snap_to_levels, to_width_rates,
                   validate_width_geometry)
