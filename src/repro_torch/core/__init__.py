"""VELOC core: very low overhead multi-level asynchronous checkpointing."""
from repro_torch.core.api import (Cluster, VelocClient,  # noqa: F401
                                  VelocConfig, make_client)
from repro_torch.core.backend import (ActiveBackend,  # noqa: F401
                                      AdmissionError, LanePolicy,
                                      RateLimiter)
from repro_torch.core.datastates import DataStates, Snapshot  # noqa: F401
from repro_torch.core.future import (CheckpointError,  # noqa: F401
                                     CheckpointFuture)
from repro_torch.core.pipeline import (MODULES, ModuleRegistry,  # noqa: F401
                                       ModuleSpec, PipelineSpec,
                                       register_module)
from repro_torch.core.storage import (TIERS, TierRegistry,  # noqa: F401
                                      TierSpec, TierTopology, register_tier)
