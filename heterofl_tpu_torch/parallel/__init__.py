"""Round execution and evaluation on one GPU."""

from .evaluation import Evaluator  # noqa: F401
from .round_engine import RoundEngine, client_seed  # noqa: F401
