"""Round execution and evaluation on one GPU: the masked engine (clients one
after another at full width), the grouped engine (each level's clients
batched through its dense sub-model) and the evaluator."""

from .evaluation import Evaluator  # noqa: F401
from .grouped import GroupedRoundEngine  # noqa: F401
from .round_engine import RoundEngine, client_seed  # noqa: F401
