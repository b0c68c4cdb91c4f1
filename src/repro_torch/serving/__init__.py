from repro_torch.serving.api import LLM, RequestOutput, Session  # noqa: F401
from repro_torch.serving.engine import (EngineConfig,  # noqa: F401
                                        EngineCore, Request, ServingEngine,
                                        StepOutput)
from repro_torch.serving.prefix_cache import (ChaiSnapshot,  # noqa: F401
                                              PrefixCache)
from repro_torch.serving.sampling import SamplingParams  # noqa: F401
