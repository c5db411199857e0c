from repro_torch.engines.grape.engine import GrapeEngine  # noqa: F401
from repro_torch.engines.grape import algorithms  # noqa: F401
