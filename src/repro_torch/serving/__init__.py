from repro_torch.serving.plan_cache import (CacheStats, PlanCache,  # noqa: F401
                                            plan_key)
from repro_torch.serving.service import (EngineBinding,  # noqa: F401
                                         QueryService, Request, Response,
                                         ServingStats)
